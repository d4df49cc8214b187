"""The benchmark's plain reference: float64 (or, for the control, a lower
precision) PyTorch over the benchmark's own inputs. It imports nothing of
the program: the physics, observation, reward and library code are the
frozen copies in `frozen/`; the networks, GAE, PPO and Adam are written
out here."""
