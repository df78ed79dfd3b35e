"""The port's dry run of the expert, Mamba2/hybrid and encoder-decoder
families on a fake 2×4 ``("data", "model")`` mesh, on the CPU at reduced
size: granite-moe and phi3.5-moe (the expert dispatch per batch shard or
whole), mamba2-1.3b and zamba2-7b (the SSD scan per (batch, head) shard)
and whisper-small (the decode's cross-attention lengths, the training
step's norm statistics) at the four input shapes. Every case gives ``ok``
(whisper's ``long_500k`` is skipped, as in JAX) with the argument bytes of
the JAX package's ``memory_summary`` of the same step (train: 4 bytes
less, JAX's int32 step counter).

About 70 s in one process on the CPU; the JAX side's compiles run in
a subprocess beside the port's cases.
"""
import pytest

pytest.importorskip("torch")

import dryrun_cases as C  # noqa: E402

MESH = "2x4"
ARCHS = ("granite-moe", "phi3.5-moe", "mamba2-1.3b", "zamba2-7b",
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
