"""Faults planted under the timed path, each of which the check must
catch (`correct` false): the tests under portbench/tests run them on the
CPU, and portbench/control.py on the card.

- state_unchanged: every decide launch works on a copy of the table, so
  the table never changes;
- half_left_out: the columnar prep's second half of each window's lanes is
  turned into padding, so those requests are never decided;
- answer_altered: one answer of every window read back has its remaining
  raised by one where the response is produced.

The configurations here run on one card, so there is no exchange between
cards to leave out.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def state_unchanged():
    from gubernator_tpu_torch.models import engine as em

    names = [n for n in dir(em) if n.startswith(("decide_packed",
                                                 "decide_scan_packed"))]
    with contextlib.ExitStack() as stack:
        for n in names:
            fn = getattr(em, n)

            def on_copy(state, *args, _fn=fn):
                return _fn(state.clone(), *args)

            stack.enter_context(_patched(em, n, on_copy))
        yield


@contextlib.contextmanager
def half_left_out():
    from gubernator_tpu_torch import native

    prep = native.prep_pack_columnar

    def half(directory, n, keys, key_off, name_len, hits, limit, duration,
             algorithm, behavior, slow_mask, packed, inject=None):
        out = prep(directory, n, keys, key_off, name_len, hits, limit,
                   duration, algorithm, behavior, slow_mask, packed, inject)
        n0 = out[0]
        if n0 > 1:
            packed[0, n0 // 2:n0] = -1  # slot -1: a padding lane
        return out

    with _patched(native, "prep_pack_columnar", half):
        yield


@contextlib.contextmanager
def answer_altered():
    from gubernator_tpu_torch.ops.staging import WindowStaging

    fetch = WindowStaging.fetch

    def altered(handle):
        rows = fetch(handle)
        rows[..., 2, 0] += 1
        return rows

    with _patched(WindowStaging, "fetch", staticmethod(altered)):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_left_out": half_left_out,
          "answer_altered": answer_altered}
