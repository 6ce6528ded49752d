"""Host-side data: synthetic corpus, FPGrowth mining, packed incidence."""
