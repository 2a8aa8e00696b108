"""The constrained-PPO learner of the port: losses, Lagrange multiplier, update."""
