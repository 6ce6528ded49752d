"""Architecture configurations of the port (the LM family so far)."""
