"""repro_torch — the tiering-SCSK system on PyTorch and hand-written CUDA.

A second package beside `repro` (the JAX reference). It keeps the reference's
module names, so `repro_torch.core.greedy` is the counterpart of
`repro.core.greedy`, and imports neither `jax` nor anything of `repro`.

Packed bitsets are `torch.int32` tensors holding the reference's uint32 bit
pattern. Entry points run on CUDA unless the caller passes `device="cpu"`;
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
