"""repro_torch.ingest — live document ingestion with streaming Tier-1 admission.

The port's counterpart of `repro.ingest`, with the same names.

The corpus becomes mutable end to end: `data.incidence.append_docs` grows
the packed structures by word-aligned blocks (existing words never move),
`DocumentFeed` delivers drift-correlated arrivals, `AdmissionPolicy` makes
one-pass secretary-style admit decisions under live knapsack caps, and
`IngestController` splices the ingest leg into the serve → refit loop while
`TieredCluster.swap_corpus` rolls the new corpus version replica-by-replica
with zero downtime.

CLI: `python -m repro_torch.launch.ingest --scale tiny --windows 6 --verify`
(`--device cpu` off the card)
"""
from repro_torch.ingest.admission import AdmissionDecision, AdmissionPolicy
from repro_torch.ingest.controller import (IngestController, IngestReport,
                                           IngestWindowReport, run_ingest)
from repro_torch.ingest.feed import DocumentFeed

__all__ = [
    "AdmissionDecision", "AdmissionPolicy", "DocumentFeed",
    "IngestController", "IngestReport", "IngestWindowReport", "run_ingest",
]
