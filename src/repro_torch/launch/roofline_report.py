"""The roofline table of the port's dry-run records
(``results/dryrun_torch/*.json``, ``launch.dryrun``): three terms per
(arch × shape) on one mesh.

  compute    = flops(per device) / peak bf16 FLOP/s
  memory     = bytes accessed(per device) / HBM rate
  collective = collective bytes(per device) / NVLink rate (2 directions)

The peak and HBM rates are the H100 SXM data sheet's, as
``core.hardware.H100`` holds them (989 TFLOP/s bf16, 3.35 TB/s); the link
rate is NVLink 4's data-sheet 900 GB/s of an H100 SXM. MODEL_FLOPS is
6·N·D for training (6·N_active·D for MoE), 2·N·D for inference, and the
useful-compute ratio is MODEL_FLOPS / (traced flops × devices).

Its own copies of ``model_flops``, ``load_records`` and ``roofline_terms``
(the JAX package's ``benchmarks/roofline.py``), since the port imports
nothing of that package. Run: ``python -m repro_torch.launch.roofline_report
card`` (or ``16x16``, ``2x16x16``).
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import List, Optional

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core.hardware import H100

RESULTS_DIR = os.environ.get("DRYRUN_DIR", "results/dryrun_torch")
# the whole card's data-sheet rates (H100 holds them per GPU percent)
PEAK_FLOPS = H100.peak_flops * H100.chips_per_pod
HBM_BW = H100.hbm_bw * H100.chips_per_pod
NVLINK_BW = 900e9          # NVLink 4, H100 SXM data sheet, both directions
NODE_GPUS = 8


def model_flops(cfg, shape) -> float:
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token


def load_records(mesh: str = "card", results_dir: str = None) -> List[dict]:
    d = results_dir or RESULTS_DIR
    return [json.load(open(f)) for f in
            sorted(glob.glob(os.path.join(d, f"*__{mesh}.json")))]


def roofline_terms(rec: dict) -> Optional[dict]:
    if not rec.get("ok") or rec.get("skipped"):
        return None
    cfg = get_config(rec["arch"])
    shape = INPUT_SHAPES[rec["shape"]]
    n_dev = rec.get("n_devices", 1)
    flops = rec["flops_per_device"]
    coll = rec["collective_bytes"]
    t_comp = flops / PEAK_FLOPS
    t_mem = rec["bytes_per_device"] / HBM_BW
    # the bytes are per-device results: a ring all-reduce moves ~2x its
    # result per device, an all-to-all ~1x
    ar = sum(v for k, v in coll.items() if k != "all-to-all")
    a2a = coll.get("all-to-all", 0.0)
    t_coll = (2.0 * ar + a2a) / NVLINK_BW
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    total = rec["memory"]["total_per_device"]
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "model_flops": mf,
        "useful_ratio": mf / max(flops * n_dev, 1.0),
        "mem_gb_per_device": total / 1e9,
        "fits_hbm": rec.get("fits", total <= H100.hbm_bytes),
    }


def main(mesh: str = "card", results_dir: str = None) -> None:
    print(f"# mesh {mesh}: H100 SXM data sheet, {PEAK_FLOPS / 1e12:.0f} "
          f"TFLOP/s bf16, {HBM_BW / 1e12:.2f} TB/s HBM, NVLink 4 "
          f"{NVLINK_BW / 1e9:.0f} GB/s; a mesh wider than one node's "
          f"{NODE_GPUS} GPUs crosses InfiniBand, which the collective term "
          f"does not model")
    print("| arch | shape | compute | memory | collective | dominant "
          "| MODEL/traced flops | GB/dev | fits |")
    print("|---|---|---|---|---|---|---|---|---|")
    for rec in load_records(mesh, results_dir):
        rt = roofline_terms(rec)
        if rt is None:
            why = "skipped" if rec.get("skipped") else "failed"
            print(f"| {rec['arch']} | {rec['shape']} | — | — | — | {why} "
                  f"| — | — | — |")
            continue
        print(f"| {rec['arch']} | {rec['shape']} "
              f"| {rt['compute_s']*1e3:.2f} ms | {rt['memory_s']*1e3:.2f} ms "
              f"| {rt['collective_s']*1e3:.2f} ms | {rt['dominant']} "
              f"| {rt['useful_ratio']:.2f} | {rt['mem_gb_per_device']:.1f} "
              f"| {'Y' if rt['fits_hbm'] else 'N'} |")


if __name__ == "__main__":
    main(*sys.argv[1:3])
