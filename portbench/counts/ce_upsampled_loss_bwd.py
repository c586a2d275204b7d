"""The backward of ``ce_upsampled_loss``: reads logits and labels, writes
bf16 dlogits; per upsampled value the interpolation (7), the softmax (5) and
the interpolation's adjoint (8)."""


def work(shape: dict) -> tuple[float, float, float]:
    n, h, w, k, s = (shape[q] for q in ("n", "h", "w", "k", "s"))
    pixels = n * h * s * w * s
    return 2 * n * h * w * k * 2 + pixels + 4, 0.0, 20.0 * pixels * k
