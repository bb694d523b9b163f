from gubernator_tpu_torch.ops.decide import ReqBatch, RespBatch, make_table
from gubernator_tpu_torch.ops.ring import ring_all_reduce

__all__ = ["ReqBatch", "RespBatch", "make_table", "ring_all_reduce"]
