#!/usr/bin/env python3
"""How the split synthesis path holds device memory in CUDA graph pools as
one shape meets more trimmed Griffin-Lim lengths, and what each call takes.

    PYTHONPATH=. python3 tools/gl_graph_memory.py [--label change] \\
        [--out out/gl_graph_memory_change.json]

One ``Synthesizer`` at synth_fast (trim before Griffin-Lim; GL 100 at
momentum 0.99 in the kernel's bf16 mode) with full_1chip widths and
seeded random weights, on 8 prompts at 500 decoder steps (1000 frames).
Random weights give every call the same end frames, so the length rule is
replaced: the k-th length is 64 k, sixteen lengths (64 to 960, and 1000)
as a quantum of 64 gives them on 1000 frames. Each length is called twice;
after the second the script records the memory the caching allocator
reserves, all of it and in CUDA graph pools, the Griffin-Lim graphs the
shape keeps, if the package keeps any (a package that captures one per
length holds it in ``ShapeGraphs.gl``), and their pools, and each call's
wall time. Then every length once more in the same order, with each
call's wall time. It measures the package on ``PYTHONPATH``, so that
another checkout is measured the same way. Prints one JSON line per length
and writes all to ``--out``. Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

PROMPTS = [
    "The birch canoe slid on the smooth planks, and the boy glued the sheet to the dark blue "
    "background.",
    "It is easy to tell the depth of a well, but four hours of steady work faced us before the "
    "sun went down.",
    "A large size in stockings is hard to sell, so the merchant kept them in the back of the "
    "narrow shop all winter.",
    "The juice of lemons makes fine punch; the box was thrown beside the parked truck near the "
    "old stone bridge.",
    "Glue the sheet to the dark blue background, then rake the leaves into a pile and let the "
    "wind carry them off.",
    "These days a chicken leg is a rare dish, and the hogs were fed chopped corn and garbage "
    "before the market opened.",
    "Rice is often served in round bowls; the small pup gnawed a hole in the sock while the "
    "family slept late.",
    "Four hours of steady work faced us, and a rod is used to catch pink salmon in the cold "
    "rivers of the north.",
]
LENGTHS = [*range(64, 1000, 64), 1000]
MIB = 2 ** 20


def graph_pool_bytes() -> int:
    """Bytes the caching allocator reserves in CUDA graph pools (every
    segment outside the default pool)."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg["segment_pool_id"]) != (0, 0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out_path = args.out or f"out/gl_graph_memory_{args.label}.json"

    import torch

    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.data.vocab import Vocab
    from tacotron_tpu_torch.infer import Synthesizer, synthesize
    from tacotron_tpu_torch.models.tacotron import Tacotron
    from tacotron_tpu_torch.weights import init_params, split_state

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()

    class LengthSet(Synthesizer):
        t_gl = None

        def _t_gl(self, ends, frames):
            return self.t_gl

    cfg = get_config("synth_fast")
    cfg = cfg.replace(infer=dataclasses.replace(cfg.infer, early_exit=False))
    dev = torch.device("cuda")
    model = init_params(Tacotron(cfg.model, device=dev), seed=0).eval()
    synth = LengthSet(cfg, *split_state(model), Vocab.build(PROMPTS))
    del model
    print(f"card: {card}; package {synthesize.__file__}", flush=True)

    def call(t):
        synth.t_gl = t
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = synth(PROMPTS, seed=0)
        torch.cuda.synchronize()
        return res["graphed"], (time.perf_counter() - t0) * 1e3

    rows = []
    for k, t in enumerate(LENGTHS, 1):
        first, second = call(t), call(t)
        (entry,) = synth.graphs.values()
        kept = {t_: g for t_, g in getattr(entry, "gl", {}).items() if g is not None}
        row = {"lengths_seen": k, "t_gl": t, "calls_graphed": [first[0], second[0]],
               "calls_ms": [first[1], second[1]], "gl_graphs_kept": sorted(kept),
               "gl_pool_mib": {t_: g.pool_bytes / MIB for t_, g in kept.items()},
               "gl_pools_kept_mib": sum(g.pool_bytes for g in kept.values()) / MIB,
               "model_pools_mib": sum(g.pool_bytes for g in entry.model.values()) / MIB,
               "graph_pools_reserved_mib": graph_pool_bytes() / MIB,
               "reserved_mib": torch.cuda.memory_reserved() / MIB}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del entry, kept        # hold no graph the next call may drop
    revisit = []
    for t in LENGTHS:
        graphed, ms = call(t)
        revisit.append({"t_gl": t, "graphed": graphed, "ms": ms})
    print(json.dumps({"revisit": revisit}), flush=True)
    report = {"label": args.label, "card": card,
              "package": synthesize.__file__, "lengths": rows, "revisit": revisit,
              "config": "synth_fast, full_1chip widths, B 8, 500 decoder steps, GL 100 bf16"}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    for n in (2, 4, 8, 16):
        r = rows[n - 1]
        print(f"{args.label}: after {n} lengths seen twice: graph pools reserved "
              f"{r['graph_pools_reserved_mib']:.1f} MiB (kept Griffin-Lim graphs "
              f"{len(r['gl_graphs_kept'])}, their pools {r['gl_pools_kept_mib']:.1f} MiB; model "
              f"graphs {r['model_pools_mib']:.1f} MiB), all reserved {r['reserved_mib']:.1f} MiB; "
              f"{card}", flush=True)


if __name__ == "__main__":
    main()
