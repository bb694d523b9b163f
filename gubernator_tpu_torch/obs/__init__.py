"""Observability the serving path needs: the lock-order witness
(obs/witness.py) and the span tracer (obs/trace.py), copies of the JAX
package's modules of the same names, kept equal to them by
tests/test_torch_copies.py."""
