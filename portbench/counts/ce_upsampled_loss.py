"""Cross-entropy of the x s bilinear upsample of bf16 logits (n, h, w, k)
against uint8 labels (n, h s, w s): the weighted sum and the correct count.
Per upsampled value: the interpolation (7) and the log-sum-exp (3); per
pixel: the label's pick and the sums (4)."""


def work(shape: dict) -> tuple[float, float, float]:
    n, h, w, k, s = (shape[q] for q in ("n", "h", "w", "k", "s"))
    pixels = n * h * s * w * s
    return n * h * w * k * 2 + pixels + 8, 0.0, 10.0 * pixels * k + 4.0 * pixels
