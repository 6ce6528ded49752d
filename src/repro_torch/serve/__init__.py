"""Two-tier serving: conjunctive matching and the tiered engine."""
