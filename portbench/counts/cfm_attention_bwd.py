"""The CFM window attention backward: reads q, K, V, bias, mask and the
output cotangent; writes dq, dK, dV (bf16) and the f32 bias gradient."""

from .cfm_attention import work as _fwd


def work(shape: dict) -> tuple[float, float, float]:
    nw, lq, keys, c, nh = (shape[k] for k in ("nw", "lq", "keys", "c", "nh"))
    nbytes, tensor, f32 = _fwd(shape)
    nbytes += nw * lq * c * 2 + 2 * nw * keys * c * 2 + nh * lq * keys * 4
    return nbytes, 2 * tensor, 2 * f32
