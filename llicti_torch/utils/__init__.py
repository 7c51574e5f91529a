"""Checkpoints, experiment logging and notifications of the trainer."""
from .checkpoint import CheckpointManager
from .logging_utils import RateLogger, setup_logging
from .notify import Notifier
