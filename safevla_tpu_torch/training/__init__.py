"""The online trainer: environment pool -> rollout runner -> learner."""
