"""The port's ring all-reduce and GLOBAL sync against the JAX package's, bit
for bit, plus the port's import and device contracts.

- The plain ring (ops/ring.py) against the JAX Pallas ring
  (make_ring_all_reduce) in interpret mode on a 1-D CPU mesh, as
  tests/test_ring.py runs it.
- make_global_sync(collectives="ring") and ("psum") on the CPU against the
  JAX make_global_sync(collectives="psum") on a 1 x S mesh of the virtual
  CPU devices: equal mirrors and equal shard tables over several steps.
- The port imports with JAX blocked, never names the JAX package in an
  import, and its entry points refuse to run on a CPU they were not asked
  for.
"""

import ast
import datetime as dt
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from gubernator_tpu_torch import convert
from gubernator_tpu_torch.ops.ring import ring_all_reduce, ring_all_reduce_plain
from gubernator_tpu_torch.parallel import (
    MeshPlan,
    make_global_sync,
    make_sharded_table,
    shard_of_key,
)
from gubernator_tpu_torch.types import Behavior
from gubernator_tpu_torch.utils.gregorian import gregorian_duration, gregorian_expiration

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "gubernator_tpu_torch"
NOW = 1_700_000_000_000


@pytest.mark.parametrize("n_devices,length", [(4, 16), (8, 64), (2, 8)])
def test_plain_ring_matches_pallas_ring(n_devices, length):
    from gubernator_tpu.ops.ring import make_ring_all_reduce

    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("shard",))
    ring = make_ring_all_reduce(n_devices, length, axis_name="shard")
    rng = np.random.RandomState(n_devices)
    x = rng.randint(-1000, 1000, (n_devices, length)).astype(np.int64)
    x[0, 0] = np.iinfo(np.int64).max  # the sum wraps
    ring_fn = jax.jit(jax.shard_map(
        lambda v: ring(v.reshape(-1)).reshape(1, -1),
        mesh=mesh, in_specs=P("shard", None), out_specs=P("shard", None),
        check_vma=False))
    want = np.asarray(ring_fn(jnp.asarray(x)))
    got = ring_all_reduce(torch.from_numpy(x))
    np.testing.assert_array_equal(want, convert.to_numpy(got))
    np.testing.assert_array_equal(convert.to_numpy(ring_all_reduce_plain(
        torch.from_numpy(x))), want)


def _global_setup(rng, S, C, G):
    """A populated [1, S, C, 8] table and a GlobalConfig as numpy fields:
    registered keys at slots of their owner shard, a few unregistered,
    token and leaky, some gregorian."""
    table = np.zeros((1, S, C, 8), np.int64)
    table[..., 0] = -1
    keys = [f"global_{i}" for i in range(G)]
    owner = np.array([shard_of_key(k, S) for k in keys], np.int32)
    slot = np.full(G, -1, np.int32)
    for s in range(S):
        mine = np.flatnonzero(owner == s)
        slot[mine] = rng.choice(C, len(mine), replace=False)
    slot[rng.rand(G) < 0.1] = -1  # not registered yet
    behavior = np.where(rng.rand(G) < 0.2, int(Behavior.DURATION_IS_GREGORIAN),
                        0).astype(np.int32)
    duration = np.where(behavior != 0, rng.randint(0, 3, G),
                        rng.choice([1000, 60_000], G)).astype(np.int64)
    local = dt.datetime.fromtimestamp(NOW / 1000.0)
    greg = behavior != 0
    cfg = dict(
        slot=slot, owner=owner,
        limit=rng.choice([5, 50, 1000], G).astype(np.int64),
        duration=duration,
        algorithm=rng.randint(0, 2, G).astype(np.int32),
        behavior=behavior,
        greg_expire=np.array([gregorian_expiration(local, int(c)) if g else 0
                              for g, c in zip(greg, duration)], np.int64),
        greg_interval=np.array([gregorian_duration(local, int(c)) if g else 0
                                for g, c in zip(greg, duration)], np.int64),
        fresh=np.ones(G, np.bool_),
    )
    return table, cfg


@pytest.mark.parametrize("collectives", ["ring", "psum"])
@pytest.mark.parametrize("S", [4, 8])
def test_global_sync_matches_jax_psum(collectives, S):
    from gubernator_tpu.parallel import global_sync as jgs
    from gubernator_tpu.parallel.mesh import MeshPlan as JPlan, make_mesh

    rng = np.random.RandomState(S)
    C, G = 64, 32
    table, cfg = _global_setup(rng, S, C, G)
    jplan = JPlan(mesh=make_mesh(n_shards=S), capacity_per_shard=C)
    jsync = jgs.make_global_sync(jplan, collectives="psum")
    jstate = jax.device_put(table, jplan.state_sharding())
    tsync = make_global_sync(MeshPlan(n_shards=S, capacity_per_shard=C),
                             collectives=collectives, device="cpu")
    tstate = convert.table_to_torch(table, "cpu")
    for step in range(4):
        now = NOW + step * 3_000
        delta = rng.randint(0, 4, (1, S, G)).astype(np.int64)
        jcfg = jgs.GlobalConfig(**{k: jnp.asarray(v) for k, v in cfg.items()})
        jstate, jmirror, jdelta = jsync(jstate, delta, jcfg, now)
        tcfg = convert.global_config_to_torch(jgs.GlobalConfig(**cfg), "cpu")
        tstate2, tmirror, tdelta = tsync(
            tstate, convert.to_torch(delta, np.int64, "cpu"), tcfg, now)
        assert tstate2 is tstate  # updated in place
        want, got = convert.fields_to_numpy(jmirror), convert.fields_to_numpy(tmirror)
        for f in want:
            assert want[f].dtype == got[f].dtype, f
            np.testing.assert_array_equal(want[f], got[f], err_msg=f)
        np.testing.assert_array_equal(np.asarray(jstate),
                                      convert.table_to_numpy(tstate))
        assert not convert.to_numpy(tdelta).any()
        assert np.asarray(jdelta).shape == tuple(tdelta.shape)
        cfg["fresh"] = np.zeros(G, np.bool_)


def test_global_sync_contract():
    plan = MeshPlan(n_shards=4, capacity_per_shard=8)
    with pytest.raises(ValueError, match="unknown collectives"):
        make_global_sync(plan, collectives="nccl", device="cpu")
    with pytest.raises(ValueError, match="single-region"):
        make_global_sync(MeshPlan(n_shards=2, capacity_per_shard=8,
                                  n_regions=2), collectives="ring", device="cpu")
    state = make_sharded_table(plan, device="cpu")
    assert tuple(state.shape) == (1, 4, 8, 8)
    assert (state[..., 0] == -1).all() and (state[..., 1:] == 0).all()


def test_convert_round_trips():
    rng = np.random.RandomState(0)
    table = rng.randint(-9, 9, (2, 3, 5, 8)).astype(np.int64)
    np.testing.assert_array_equal(
        convert.table_to_numpy(convert.table_to_torch(table, "cpu")), table)
    lanes = rng.randint(-2**31, 2**31 - 1, (4, 16)).astype(np.int32)
    cfg = rng.randint(0, 9, (128, 4)).astype(np.int64)
    tl, tc = convert.staging_to_torch(lanes, cfg, device="cpu")
    np.testing.assert_array_equal(convert.to_numpy(tl), lanes)
    np.testing.assert_array_equal(convert.to_numpy(tc), cfg)
    wide = rng.randint(0, 9, (9, 16)).astype(np.int64)
    assert convert.staging_to_torch(wide, device="cpu").dtype == torch.int64
    compact = rng.randint(0, 9, (3, 5, 16)).astype(np.int32)
    assert convert.staging_to_torch(compact, device="cpu").dtype == torch.int32
    mirror = dict(status=np.array([0, 1], np.int32),
                  limit=np.array([5, 2**40], np.int64),
                  remaining=np.array([-1, 3], np.int64),
                  reset_time=np.array([0, 9], np.int64))
    back = convert.fields_to_numpy(convert.global_mirror_to_torch(
        SimpleNamespace(**mirror), "cpu"))
    for f, v in mirror.items():
        assert back[f].dtype == v.dtype
        np.testing.assert_array_equal(back[f], v)
    with pytest.raises(ValueError):
        convert.table_to_torch(np.zeros((4, 7), np.int64), "cpu")
    with pytest.raises(ValueError):
        convert.to_torch(np.zeros(3, np.int32), np.int64, "cpu")


def test_imports_without_jax():
    """The port and chip_smoke.py import with JAX blocked."""
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in PORT.rglob("*.py"))
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['gubernator_tpu'] = None; import importlib; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "import chip_smoke")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "gubernator_tpu"), (path, name)


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """Without CUDA and without device="cpu" the entry points raise."""
    from gubernator_tpu_torch.models import Engine
    from gubernator_tpu_torch.ops.decide import make_table

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = MeshPlan(n_shards=2, capacity_per_shard=8)
    for build in (lambda: Engine(capacity=16), lambda: make_table(8),
                  lambda: make_global_sync(plan),
                  lambda: make_sharded_table(plan)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert Engine(capacity=16, device="cpu").state.device.type == "cpu"


def test_ring_wrapper_refuses_cpu_tensors():
    from gubernator_tpu_torch.ops.ring import ring_all_reduce_cuda

    with pytest.raises(ValueError, match="CUDA"):
        ring_all_reduce_cuda(torch.zeros((2, 4), dtype=torch.int64))
