"""ray_tpu_torch.tune: hyperparameter search.

The port of ``ray_tpu.tune``, module for module (``sample``, ``trial``,
``schedulers``, ``suggest``, ``trainable``, ``trial_runner``,
``analysis``, ``tune``).  Every seeded draw comes from the
``random.Random`` the reference seeds, so a seeded searcher or scheduler
makes the reference's decisions.  A trial's actor takes
``resources_per_trial["gpu"]`` as its ``num_gpus`` (ROADMAP C.32).

Parity: reference ``python/ray/tune/`` — ``tune.run`` + TrialRunner
event loop, search spaces (sample.py), BasicVariantGenerator + Searcher
ABC, trial schedulers (FIFO/ASHA/median-stopping/PBT), function and
class trainables, ExperimentAnalysis.
"""

from ray_tpu_torch.tune.analysis import ExperimentAnalysis  # noqa: F401
from ray_tpu_torch.tune.sample import (  # noqa: F401
    choice, grid_search, loguniform, qrandint, quniform, randint,
    sample_from, uniform)
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    AsyncHyperBandScheduler, FIFOScheduler, HyperBandScheduler,
    MedianStoppingRule, PopulationBasedTraining, TrialScheduler)
from ray_tpu_torch.tune.suggest import (  # noqa: F401
    BasicVariantGenerator, Searcher, TPESearcher, TuneBOHB)
from ray_tpu_torch.tune.trainable import (  # noqa: F401
    Trainable, get_trial_id, load_checkpoint, report, save_checkpoint)
from ray_tpu_torch.tune.trial import Trial  # noqa: F401
from ray_tpu_torch.tune.trial_runner import TrialRunner, TuneError  # noqa: F401
from ray_tpu_torch.tune.tune import run  # noqa: F401

ASHAScheduler = AsyncHyperBandScheduler

__all__ = [
    "ASHAScheduler", "AsyncHyperBandScheduler", "BasicVariantGenerator",
    "ExperimentAnalysis", "FIFOScheduler", "HyperBandScheduler",
    "MedianStoppingRule", "PopulationBasedTraining", "Searcher",
    "TPESearcher", "Trainable", "Trial", "TrialRunner", "TrialScheduler",
    "TuneBOHB", "TuneError", "choice", "get_trial_id",
    "grid_search", "load_checkpoint", "loguniform", "qrandint", "quniform",
    "randint", "report", "run", "sample_from", "save_checkpoint", "uniform",
]
