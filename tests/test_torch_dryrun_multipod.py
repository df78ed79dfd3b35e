"""The port's dry run on a fake 2×2×2 ``("pod", "data", "model")`` mesh,
the two-pod layout, on the CPU at reduced size: one arch per family
(olmo-1b, granite-moe, mamba2-1.3b, zamba2-7b, whisper-small) at the four
input shapes. A prefill batch of 2 does not divide pod × data = 4, so it
is replicated over both, as the JAX package's ``resolve_spec`` falls back
(``layers._rows``/``_unrows``). Every case gives ``ok`` (whisper's
``long_500k`` is skipped, as in JAX) with the argument bytes of the JAX
package's ``memory_summary`` of the same step (train: 4 bytes less, JAX's
int32 step counter).

About 145 s in one process on the CPU (most of it the training
steps' DTensor redistributions over three mesh dims); the JAX side's
compiles run in a subprocess beside the port's cases.
"""
import pytest

pytest.importorskip("torch")

import dryrun_cases as C  # noqa: E402

MESH = "2x2x2"
ARCHS = ("olmo-1b", "granite-moe", "mamba2-1.3b", "zamba2-7b",
         "whisper-small")


@pytest.fixture(scope="module")
def jax_bytes():
    got = C.JaxBytes(ARCHS, MESH)
    yield got
    got.close()


@pytest.mark.parametrize("shape", list(C.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_takes_the_case_with_jax_argument_bytes(
        monkeypatch, jax_bytes, tmp_path, arch, shape):
    C.use_reduced(monkeypatch, MESH)
    C.check_case(jax_bytes, arch, shape, MESH, tmp_path)
