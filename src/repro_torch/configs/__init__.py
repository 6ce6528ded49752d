"""Architecture configurations of the port: the LM family (gemma2-2b,
gemma3-12b, internlm2-1.8b, and the MoE models kimi-k2-1t-a32b and
llama4-maverick-400b-a17b) and the recsys family (deepfm, bst, bert4rec,
two-tower-retrieval)."""
