from repro_torch.kernels import ops, ref  # noqa: F401
