"""Stars core: sketches, windows, the per-repetition program, the session."""
