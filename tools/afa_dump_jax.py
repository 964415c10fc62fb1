#!/usr/bin/env python3
"""Screen a dumped AFA round with the JAX package, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/afa_dump_jax.py \
        chiprun_out/lora_round7_gram_fused.npz

The file is one written by ``chip_smoke.py``'s LoRA phase: the packed (K, D)
proposals, ``n_k``, the participation mask and the reputation means of one
round.  Runs ``repro.core.afa.afa_aggregate`` on them with the gram and the
iterative variant on the plain ``jnp`` route (the server's defaults xi0 = 2,
delta_xi = 0.5, max_rounds = 8) and prints the decisions and similarities,
then the gram variant's first screening pass in float64 on the host: each
live client's similarity and signed margin to the tail threshold (negative:
in the tail).  Compare with the port's routes in ``chip_smoke.py``'s output.
"""

from __future__ import annotations

import sys

import numpy as np


def float64_first_pass(u, pn, mask, xi0=2.0, ddof=0):
    g = u @ u.T
    rn = np.sqrt((u * u).sum(axis=1))
    c = np.where(mask, pn, 0.0)
    c = c / max(c.sum(), 1e-12)
    gc = g @ c
    s = gc / (np.maximum(rn, 1e-12) * np.sqrt(max(c @ gc, 1e-12)))
    live = s[mask]
    mu, med = live.mean(), np.median(live)
    sigma = np.sqrt(((live - mu) ** 2).sum() / max(live.size - ddof, 1))
    low = mu < med
    thr = med - xi0 * sigma if low else med + xi0 * sigma
    margin = (s - thr) if low else (thr - s)
    return s, thr, margin, low


def main(path: str) -> None:
    import jax.numpy as jnp

    from repro.core.afa import AFAConfig, afa_aggregate

    d = np.load(path)
    u, n_k, mask0, p = d["proposals"], d["n_k"], d["mask0"].astype(bool), d["p_good"]
    print(f"{path}: K={u.shape[0]} D={u.shape[1]} mask0={mask0.astype(int).tolist()} "
          f"p_good={p.tolist()}")
    for variant in ("gram", "iterative"):
        res = afa_aggregate(jnp.asarray(u), jnp.asarray(n_k), jnp.asarray(p),
                            mask0=jnp.asarray(mask0),
                            config=AFAConfig(variant=variant, use_kernels="jnp"))
        print(f"  jax {variant:9s} (jnp): good_mask="
              f"{np.asarray(res.good_mask).astype(int).tolist()} rounds={int(res.rounds)} "
              f"sims={[f'{x:.8f}' for x in np.asarray(res.similarities)]}")
    s, thr, margin, low = float64_first_pass(u.astype(np.float64), (p * n_k).astype(np.float64),
                                             mask0)
    print(f"  float64 pass 1: tail={'low' if low else 'high'} threshold={thr:.9g}")
    print("    " + " ".join(f"k{k}: s={s[k]:.9g} margin={margin[k]:+.3e}"
                            for k in np.flatnonzero(mask0)))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
