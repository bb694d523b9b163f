"""The port's copies of JAX-package host modules stay equal to their originals.

obs/witness.py, obs/trace.py, service/deadline.py, service/combiner.py and
store.py are copied mechanically: each may differ from its original only by the
package name and the substitutions listed here, so a change on either side
shows as a failure until the other follows. (native/keydir.cpp is held byte
for byte in test_torch_native.py.)
"""

import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

# {module path under both packages: [(text in the JAX original, text in the
# port's copy)]}, beyond gubernator_tpu -> gubernator_tpu_torch. The witness
# copy dumps its observations beside the JAX witness's under its own file
# name: in one process both dump, and one must not overwrite the other.
SUBSTITUTIONS = {
    "obs/witness.py": [
        ("<dir>/witness-<pid>.json", "<dir>/witness-torch-<pid>.json"),
        ('f"witness-{os.getpid()}.json"', 'f"witness-torch-{os.getpid()}.json"'),
    ],
    "obs/trace.py": [],
    "service/deadline.py": [],
    "service/combiner.py": [],
    "store.py": [],
}


@pytest.mark.parametrize("path", sorted(SUBSTITUTIONS))
def test_copy_equals_its_original(path):
    original = (REPO / "gubernator_tpu" / path).read_text()
    copy = (REPO / "gubernator_tpu_torch" / path).read_text()
    want = original.replace("gubernator_tpu", "gubernator_tpu_torch")
    for old, new in SUBSTITUTIONS[path]:
        assert want.count(old) == 1, (path, old)
        want = want.replace(old, new)
    assert copy == want, f"gubernator_tpu_torch/{path} drifted from its original"


def test_witness_copy_reads_the_repo_lockmap():
    """The witness copy finds lockmap.json at the repository root, as the
    JAX package's does, and reads the same committed order."""
    from gubernator_tpu.obs import witness as jw
    from gubernator_tpu_torch.obs import witness as tw

    assert tw._repo_root() == str(REPO)
    edges = tw._committed_order()
    assert edges == jw._committed_order()
    assert ("combiner.window", "combiner.backlog") in edges
