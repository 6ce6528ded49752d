"""Model code of the port: the decoder-only transformer's serving path
(`transformer.forward`, `transformer.decode_step`) on the hand-written
`flash_attention` kernel, with a dense or MoE FFN (`moe`: capacity dispatch,
expert parallelism over a `"model"` mesh)."""
from repro_torch.models import common, moe, transformer  # noqa: F401

__all__ = ["common", "moe", "transformer"]
