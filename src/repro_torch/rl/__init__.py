"""The RL loop (paper Fig. 4): a trainer and rollout workers that train
and serve from their TensorHub buffers."""

from repro_torch.rl.loop import RLConfig, RolloutWorker, TrainerWorker, sample_responses

__all__ = ["RLConfig", "RolloutWorker", "TrainerWorker", "sample_responses"]
