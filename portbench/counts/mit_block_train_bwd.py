"""The whole MiT block's backward (row 7): reads the forward's inputs and the
output cotangent, writes dx, dk, dv (bf16) and the f32 parameter
gradients; twice the forward's FLOPs."""

from .mit_block_train import work as _fwd


def work(shape: dict) -> tuple[float, float, float]:
    n, h, w, c, ch, s = (shape[k] for k in ("n", "h", "w", "c", "ch", "s"))
    m = n * h * w
    nbytes, tensor, f32 = _fwd(shape)
    nbytes = nbytes - m * c * 2                          # no forward output
    nbytes += m * c * 2                                  # go
    nbytes += m * c * 2 + 2 * n * s * c * 2              # dx, dk, dv
    nbytes += (2 * c * c + 2 * c * ch + 7 * c + 11 * ch) * 4  # parameter gradients
    return nbytes, 2 * tensor, 2 * f32
