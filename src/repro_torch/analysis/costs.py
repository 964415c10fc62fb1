"""Cost analysis of a recorded call: the counterpart of ``repro/analysis/hlo.py``.

The JAX package reads its numbers from the compiled HLO text and scales a
loop body by its trip count; the port runs each loop iteration, so its
numbers are what one recorded call (``trace.record``, on ``meta``, the CPU
or the card) executed:

* ``dot_flops``: matrix-product FLOPs by ``torch.utils.flop_counter``'s
  formulas (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions,
  attention), summed over the aten operations;
* ``hbm_traffic_proxy_bytes``: the operand and result bytes of every
  operation that moves data (views left out), as if each materialised its
  result in device memory: an upper-bound proxy, blind to caching;
* ``collective_bytes`` and ``collective_counts`` by kind, from the client
  mesh's and the grid's log (bytes on the wire, this rank's).
"""

from __future__ import annotations

import json
from collections import defaultdict

from repro_torch.analysis.trace import Recording


def analyze(rec: Recording) -> dict:
    coll_bytes: dict = defaultdict(int)
    coll_counts: dict = defaultdict(int)
    for c in rec.collectives:
        coll_bytes[c.kind] += c.bytes
        coll_counts[c.kind] += 1
    return {
        "collective_bytes": dict(coll_bytes),
        "collective_bytes_total": int(sum(coll_bytes.values())),
        "collective_counts": dict(coll_counts),
        "dot_flops": int(sum(op.flops for op in rec.ops)),
        "hbm_traffic_proxy_bytes": int(sum(op.in_bytes + op.out_bytes for op in rec.ops
                                           if not op.is_view)),
        "ops": len(rec.ops),
        "kernel_calls": len(rec.calls),
    }


def analyze_to_json(rec: Recording) -> str:
    return json.dumps(analyze(rec), indent=2, sort_keys=True)
