"""The whole MiT block's train forward (row 6): the inference block's work
with f32 weights and per-frame branch scales."""

from .mit_block_fused import work as _block


def work(shape: dict) -> tuple[float, float, float]:
    nbytes, tensor, f32 = _block(shape, w_bytes=4)
    return nbytes + 2 * shape["n"] * 4, tensor, f32 + 2 * shape["n"] * shape["h"] * \
        shape["w"] * shape["c"]
