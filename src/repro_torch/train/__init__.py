"""Training of the port, the counterpart of `repro.train`: the optimizers
(`optimizer`: AdamW with low-precision states, Adafactor, SGD), the
checkpoint with atomic commit and checksums (`checkpoint`), and the trainer
(`trainer`: `make_train_step` with gradient accumulation and compression,
`TrainingDriver` with auto-resume, failure injection and a straggler
deadline). State trees are nested dicts of tensors (`tree`)."""
__all__ = ["checkpoint", "optimizer", "trainer", "tree"]
