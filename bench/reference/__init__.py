"""The plain reference of the fleet's rounds: torch and numpy only, nothing
of the program (``repro_torch``) and nothing of JAX."""
