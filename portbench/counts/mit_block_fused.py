"""The whole MiT block at inference after LN1 and the spatial-reduced K/V:
q, attention, proj, residual, LN2, fc1, 3x3 depthwise + GELU, fc2, residual.

shape: n frames of h x w tokens, c channels, ch hidden, nh heads, s keys a
frame; weights bf16 (``w_bytes`` 2), vectors f32."""


def work(shape: dict, w_bytes: int = 2) -> tuple[float, float, float]:
    n, h, w, c, ch, nh, s = (shape[k] for k in ("n", "h", "w", "c", "ch", "nh", "s"))
    m = n * h * w
    nbytes = (m * c * 2 + 2 * n * s * c * 2            # x, k, v
              + (2 * c * c + 2 * c * ch) * w_bytes      # Wq, Wproj, W1, W2
              + (7 * c + 11 * ch) * 4                   # LN, biases, depthwise taps
              + m * c * 2)                              # out
    tensor = 4 * m * c * c + 4 * m * s * c + 4 * m * c * ch
    # LN1, LN2 (8 a value each), softmax with its scale (5 a score), the
    # biases and residuals (5 a token channel), depthwise 9 MACs + bias +
    # GELU (8) a hidden value
    f32 = 16 * m * c + 5 * m * nh * s + 5 * m * c + 27 * m * ch
    return nbytes, tensor, f32
