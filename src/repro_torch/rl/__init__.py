"""The rollout side of the RL loop (paper Fig. 4b), served from TensorHub
replica buffers."""

from repro_torch.rl.loop import RLConfig, RolloutWorker, sample_responses

__all__ = ["RLConfig", "RolloutWorker", "sample_responses"]
