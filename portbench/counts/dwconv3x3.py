"""3x3 depthwise convolution + bias + exact GELU on (n, h, w, ch) bf16."""


def work(shape: dict) -> tuple[float, float, float]:
    m = shape["n"] * shape["h"] * shape["w"]
    ch = shape["ch"]
    return 2 * m * ch * 2 + 10 * ch * 4, 0.0, 27.0 * m * ch
