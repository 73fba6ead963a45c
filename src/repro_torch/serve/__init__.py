"""LM serving: the lockstep static-batch loop (the slot engine is not ported yet)."""
