"""Frozen work counts: each kernel op's bytes and FLOPs as the operation
needs them (one file an op, ``work(shape) -> (bytes, tensor_flops,
f32_flops)``), and each model's FLOPs and op calls (``<model>.py``).

Conventions, for every file here: a multiply-add is 2 FLOPs; bf16 tensors
are 2 bytes and f32 ones 4; each input is read once and each output written
once, whatever a kernel reads again or keeps for a backward; a backward's
tensor FLOPs are twice its forward's and its f32 FLOPs twice its forward's,
with nothing counted for recomputation; an exp, an erf or a division is one
f32 FLOP.
"""
