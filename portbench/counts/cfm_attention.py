"""The CFM window attention forward: q (nw, 49, c), packed K / V (nw, keys,
c) bf16, the f32 bias (nh, 49, keys) and mask (nw, keys); out like q."""


def work(shape: dict) -> tuple[float, float, float]:
    nw, lq, keys, c, nh = (shape[k] for k in ("nw", "lq", "keys", "c", "nh"))
    nq = nw * lq
    nbytes = 2 * nq * c * 2 + 2 * nw * keys * c * 2 + nh * lq * keys * 4 + nw * keys * 4
    # scale, bias, mask and softmax: 7 a score
    return nbytes, 4.0 * nq * keys * c, 7.0 * nq * nh * keys
