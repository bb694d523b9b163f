from gubernator_tpu_torch.models.keyspace import KeyDirectory
from gubernator_tpu_torch.models.engine import Engine

__all__ = ["KeyDirectory", "Engine"]
