"""ray_tpu_torch.rllib — reinforcement learning on the port's task/actor
core.

A port of ``ray_tpu.rllib`` (reference ``rllib/``: ``RolloutWorker``/
``WorkerSet``, the PPO, DQN and IMPALA trainers, replay buffers, Trainer
save/restore).  The learners and the workers' policies are float32 MLPs
under autograd on the card (``config["device"]``, or ``"cpu"``), stepped
by the port's ``Adam`` with optax's arithmetic; weights ship between
actors as numpy trees in the reference's format, and checkpoints are
interchangeable between the packages.
"""

from ray_tpu_torch.rllib.dqn import DQNTrainer, QPolicy, TransitionWorker
from ray_tpu_torch.rllib.env import CartPole
from ray_tpu_torch.rllib.impala import IMPALATrainer, TrajectoryWorker
from ray_tpu_torch.rllib.policy import ActorCritic, compute_gae
from ray_tpu_torch.rllib.ppo import DEFAULT_CONFIG, PPOTrainer
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker, WorkerSet

__all__ = ["CartPole", "ActorCritic", "compute_gae", "PPOTrainer",
           "DEFAULT_CONFIG", "RolloutWorker", "WorkerSet",
           "DQNTrainer", "QPolicy", "TransitionWorker",
           "IMPALATrainer", "TrajectoryWorker",
           "ReplayBuffer", "PrioritizedReplayBuffer"]
