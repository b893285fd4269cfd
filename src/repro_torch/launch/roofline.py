"""Roofline analysis of the port's dry-run records at NVIDIA H100 SXM
constants (port of ``repro.launch.roofline``, which uses a TPU v5e's).

Terms per (arch x shape), per device:

    compute    = flops_per_device / PEAK_FLOPS[param type]    [s]
    memory     = bytes_per_device / HBM_BW                     [s]
    collective = collective_bytes_per_device / NVLINK_BW       [s]

``MODEL_FLOPS = 6 N D`` (``N`` the active params per token, ``D`` the
tokens; a third of it for prefill and decode, which run forward only) and
``useful_ratio = MODEL_FLOPS / planned global flops`` expose recompute and
the plain attention's masked half.  ``roofline_fraction`` is the useful
flops a device does per second at the bound, over its peak.

The constants match ``chip_smoke.py``'s kernel bounds: 989e12 bf16 dense
tensor-core flop/s, 67e12 float32 flop/s, 3.35e12 B/s of HBM3, 80 GB a
card, and NVLink 4 at 450e9 B/s a direction.  The bytes term inherits the
plan's caveat: per-op bytes are an upper bound on device-memory traffic.
"""

from __future__ import annotations

import glob
import json
import os

PEAK_FLOPS = 989e12            # bf16 dense tensor-core flop/s a card
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float32": 67e12}
HBM_BW = 3.35e12               # B/s a card
NVLINK_BW = 450e9              # B/s a direction, NVLink 4
HBM_BYTES = 80e9               # device memory a card

RESULTS_DIR = os.environ.get(
    "REPRO_RESULTS_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..",
                 "results", "torch_dryrun"),
)


def _tokens(rec: dict) -> int:
    """The step's new tokens: a record's own ``tokens`` (a plan at a shape
    outside ``SHAPES``), else its shape's."""
    from repro_torch.configs.registry import SHAPES

    if "tokens" in rec:
        return rec["tokens"]
    shape = SHAPES[rec["shape"]]
    if rec["mode"] == "decode":
        return shape.global_batch  # one new token per sequence
    return shape.global_batch * shape.seq_len


def analyze_record(rec: dict) -> dict:
    sc = rec["scaled"]
    n_dev = rec["n_devices"]
    # the planned param type's peak (bf16 when the record does not say)
    peak = PEAK_FLOPS_BY_DTYPE[rec.get("param_dtype", "bfloat16")]
    compute_t = sc["flops_per_device"] / peak
    memory_t = sc["bytes_per_device"] / HBM_BW
    coll_t = sc["collective_bytes_per_device"] / NVLINK_BW
    terms = {"compute": compute_t, "memory": memory_t, "collective": coll_t}
    dominant = max(terms, key=terms.get)
    tokens = _tokens(rec)
    model_flops = 6.0 * rec["model_active_params"] * tokens
    if rec["mode"] != "train":
        model_flops /= 3.0  # forward only (no 4 N D backward)
    flops_global = sc["flops_per_device"] * n_dev
    useful = model_flops / flops_global if flops_global else 0.0
    bound = max(terms.values())
    # useful model flops per second at the bound, over the peak
    achievable_flops = model_flops / n_dev / max(bound, 1e-12)
    return {
        **{f"{k}_s": v for k, v in terms.items()},
        "dominant": dominant,
        "bound_s": bound,
        "model_flops": model_flops,
        "hlo_flops_global": flops_global,
        "useful_ratio": useful,
        "roofline_fraction": achievable_flops / peak,
        "tokens": tokens,
    }


_SUGGESTIONS = {
    ("compute", True): "compute-bound: cut remat recompute (useful_ratio "
                       "<1 means the step does non-model work, such as the "
                       "plain attention backward) or raise tensor-core use "
                       "with larger per-device GEMMs",
    ("memory", True): "memory-bound: a flash-attention backward kernel in "
                      "place of the plain VJP, fuse the CE/logits block, "
                      "bf16 activations, bigger microbatch per device",
    ("collective", True): "collective-bound: move TP all-reduces to "
                          "reduce-scatter+all-gather (SP), overlap the grad "
                          "all-reduce with backward, or compress gradients",
    ("compute", False): "compute-bound decode: batch more sequences per card",
    ("memory", False): "memory-bound decode (expected: weights+KV stream); "
                       "shrink KV (MLA/GQA already) or quantize the cache",
    ("collective", False): "collective-bound decode: keep KV model-local, "
                           "replicate small weights to kill per-step "
                           "all-reduces",
}


def load_records(mesh: str = "pod_16x16") -> list[dict]:
    out = []
    for path in sorted(
        glob.glob(os.path.join(os.path.abspath(RESULTS_DIR), mesh, "*.json"))
    ):
        with open(path) as f:
            out.append(json.load(f))
    return out


def make_table(mesh: str = "pod_16x16") -> str:
    rows = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "MODEL_FLOPS | useful | roofline_frac | GB/device | next lever |",
        "|" + "---|" * 11,
    ]
    for rec in load_records(mesh):
        if rec.get("status") == "skipped":
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | — | — | — | skipped | — "
                f"| — | — | — | {rec['skip_reason'][:60]} |")
            continue
        if rec.get("status") != "ok":
            continue
        a = analyze_record(rec)
        lever = _SUGGESTIONS[(a["dominant"], rec["mode"] == "train")]
        gb = rec["memory_analysis"]["peak_memory_in_bytes"] / 1e9
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {a['compute_s']:.3e} | "
            f"{a['memory_s']:.3e} | {a['collective_s']:.3e} | "
            f"{a['dominant']} | {a['model_flops']:.3e} | "
            f"{a['useful_ratio']:.2f} | {a['roofline_fraction']:.3f} | "
            f"{gb:.1f} | {lever[:80]} |")
    return "\n".join(rows)


def over_hbm(mesh: str = "pod_16x16") -> list[tuple[str, str, float]]:
    """The cells whose planned arguments plus temp exceed a card's 80 GB."""
    out = []
    for rec in load_records(mesh):
        if rec.get("status") != "ok":
            continue
        gb = rec["memory_analysis"]["peak_memory_in_bytes"]
        if gb > HBM_BYTES:
            out.append((rec["arch"], rec["shape"], gb / 1e9))
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod_16x16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    table = make_table(args.mesh)
    print(table)
    over = over_hbm(args.mesh)
    print(f"\ncells over {HBM_BYTES / 1e9:.0f} GB a device: "
          + (", ".join(f"{a} x {s} ({gb:.1f} GB)" for a, s, gb in over)
             or "none"))
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")


if __name__ == "__main__":
    main()
