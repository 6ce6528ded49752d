"""Architecture configurations of the port (the LM family so far: gemma2-2b,
gemma3-12b, internlm2-1.8b)."""
