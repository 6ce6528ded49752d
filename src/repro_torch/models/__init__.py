"""Model code of the port: the dense decoder-only transformer's serving path
(`transformer.forward`, `transformer.decode_step`), on the hand-written
`flash_attention` kernel."""
