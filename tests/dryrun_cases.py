"""What the dry-run family tests share (``tests/test_torch_dryrun_*.py``):
``run_one`` over reduced configs at the small shapes of
``tests/test_torch_dryrun.py`` (``long_500k`` as a decode of 8 x 256) on a
fake 2×4 or 2×2×2 mesh, and the JAX package's ``memory_summary`` of the
same steps, compiled under ``jax.jit`` on 8 forced host devices in one
subprocess that runs beside the port's cases."""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
SHAPES = {"train_4k": InputShape("train_4k", 128, 4, "train"),
          "prefill_32k": InputShape("prefill_32k", 64, 2, "prefill"),
          "decode_32k": InputShape("decode_32k", 256, 8, "decode"),
          "long_500k": InputShape("long_500k", 256, 8, "decode")}
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# JAX's train state holds an int32 step counter; the port's is a host int
STEP_COUNTER_BYTES = 4

JAX_MEMORY = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.configs.base import InputShape
    from repro.launch import dryrun, hlo_analysis

    archs, (dims, axes), shapes = {archs!r}, {mesh!r}, {shapes!r}
    mesh = Mesh(np.array(jax.devices()).reshape(dims), axes)
    for arch in archs:
        cfg = get_config(arch).reduced()
        for name, (seq, batch, kind) in shapes.items():
            shape = InputShape(name, seq, batch, kind)
            eff = dryrun.effective_config(cfg, shape)
            got = None
            if eff is not None:
                fn, args, sh = dryrun.prepare(eff, shape, mesh)
                with mesh:
                    compiled = jax.jit(fn, in_shardings=sh).lower(
                        *args).compile()
                got = hlo_analysis.memory_summary(
                    compiled)["argument_size_in_bytes"]
            print(json.dumps([arch + "/" + name, got]), flush=True)
""")


def use_reduced(monkeypatch, mesh: str) -> None:
    """``run_one`` over reduced configs, ``SHAPES`` and the fake mesh."""
    orig = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda n: orig(n).reduced())
    monkeypatch.setattr(dryrun, "get_shape", SHAPES.__getitem__)
    monkeypatch.setitem(dryrun.MESHES, mesh, MESHES[mesh])


class JaxBytes:
    """The JAX package's argument bytes of every (arch, shape) on
    ``mesh``, from a subprocess started at once that prints one case a
    line, in the tests' order: each is read when a test first asks."""

    def __init__(self, archs, mesh: str):
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        shapes = {n: (s.seq_len, s.global_batch, s.kind)
                  for n, s in SHAPES.items()}
        # stderr to a file: a full pipe nobody reads would stall the run
        self.err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", JAX_MEMORY.format(
                archs=tuple(archs), mesh=MESHES[mesh], shapes=shapes)],
            env=env, stdout=subprocess.PIPE, stderr=self.err, text=True)
        self.got = {}

    def __getitem__(self, key):
        while key not in self.got:
            line = self.proc.stdout.readline()
            if not line:
                self.proc.wait(timeout=600)
                self.err.seek(0)
                raise AssertionError(f"no JAX figure for {key} "
                                     f"(rc {self.proc.returncode}): "
                                     f"{self.err.read()[-3000:]}")
            case, got = json.loads(line)
            self.got[case] = got
        return self.got[key]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()
        self.err.close()


def check_case(jax_bytes, arch: str, shape: str, mesh: str, out_dir):
    """``run_one`` gives ``ok``; a step the JAX package skips is skipped;
    otherwise its argument bytes are JAX's (train: less the step
    counter)."""
    rec = dryrun.run_one(arch, shape, mesh, str(out_dir), verbose=False)
    assert rec["ok"], rec.get("traceback")
    want = jax_bytes[f"{arch}/{shape}"]
    if want is None:
        assert "skipped" in rec
        return rec
    assert rec["n_devices"] == 8 and rec["mesh"] == mesh
    got = rec["memory"]["argument_size_in_bytes"]
    if rec["kind"] == "train":
        want -= STEP_COUNTER_BYTES
    assert got == want, (arch, shape, got, want)
    return rec
