"""Models of the port: the SoundEventModel base, the inference engine and
the weak-label FBCRNN."""
