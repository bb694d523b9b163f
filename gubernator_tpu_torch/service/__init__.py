"""The serving tier in front of the engine: the pipelined BackendCombiner
(service/combiner.py) and the request deadlines it sheds by
(service/deadline.py), copies of the JAX package's modules of the same
names, kept equal to them by tests/test_torch_copies.py."""
