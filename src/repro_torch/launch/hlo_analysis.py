"""Roofline terms of a step on the card.

The port's counterpart of `repro.launch.hlo_analysis`. `roofline_terms`
and `dominant` keep the reference's formulas with the H100's constants in
place of the TPU v5e's. The reference's `collective_stats` parses the
collectives out of XLA's compiled HLO text; the port compiles no HLO (its
steps are eager PyTorch and hand-written kernels), so it has no
counterpart, and the dry run (`launch.dryrun`) records the collective
term as not measured.
"""
from __future__ import annotations

# H100 SXM, from NVIDIA's H100 data sheet (the figures PERF.md §3 uses):
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
# NVLink 4: the data sheet's 900 GB/s per card counts both directions of
# its 18 links; one direction, 450 GB/s, is what a card can send
NVLINK_BW = 450e9            # bytes/s per card, one direction


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float | None,
                   n_chips: int) -> dict:
    """Seconds each resource needs for a step of `flops`, `hbm_bytes` and
    `coll_bytes` (global counts) spread over `n_chips` cards; the
    collective term is None where the bytes were not measured."""
    return {
        "compute_s": flops / (n_chips * PEAK_FLOPS),
        "memory_s": hbm_bytes / (n_chips * HBM_BW),
        "collective_s": None if coll_bytes is None
        else coll_bytes / (n_chips * NVLINK_BW),
    }


def dominant(terms: dict) -> str:
    """The term that bounds the step (of those measured)."""
    return max((k for k in ("compute_s", "memory_s", "collective_s")
                if terms.get(k) is not None), key=lambda k: terms[k])
