"""Grid-race detector for the hand-written CUDA kernels.

Counterpart of ``repro/analysis/races.py``.  The TPU kernels accumulate
across a sequential grid; the port's kernels run their blocks in parallel,
so every cross-block sum goes through per-block partials (``split-
partials``) or a last-block ticket (``ticket``, ``LastBlock`` in
``afa_kernels.cu``).  For every recorded wrapper call this module rebuilds
the blocks of each of its launches at that call's geometry, from the
declarations of ``kernels/meta.py`` (H100's 132 SMs and the real pointers
on the card; the SM count it is given on the CPU), and proves:

* no element of an output or of the partial scratch is written by two
  blocks of one launch (the last block's stores come after the ticket's
  fences, so they may overwrite);
* every element that a later launch, or the ticket block, reads was written
  before it, by an earlier launch of the call or by the launch's blocks;
* every element of a returned buffer is written, and nothing outside a
  buffer is;
* the write map agrees with the declared accumulation kind: a declaration
  that lies is an ``error`` on every route.

It works on index intervals (``meta.Intervals``), so a call at K = 200,
D = 535,818 takes well under a second.

``check_sources`` reads ``csrc/*.cu``: no float atomics (``atomicAdd`` on
``float`` / ``double``, ``red.global.add.f32``), every ticket kernel draws
its ticket through ``LastBlock``, whose ``draw`` fences before and after
its ``atomicAdd`` and whose ``release`` sets the counter back to 0, and a
``__global__`` kernel with no declaration is a ``warning``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

import numpy as np

from repro_torch.analysis.report import Finding, error, warning
from repro_torch.analysis.trace import record
from repro_torch.kernels import meta

CSRC = Path(meta.__file__).resolve().parent / "csrc"
FLOAT_TYPES = frozenset({"float", "double", "half", "__half", "__nv_bfloat16", "float2",
                         "float4", "double2", "__half2", "__nv_bfloat162"})


def _overlap(iv: meta.Intervals):
    """``(element, block, other block)`` of the first element two blocks
    both write, or None."""
    if iv.starts.shape[0] < 2:
        return None
    order = np.argsort(iv.starts, kind="stable")
    s, e, b = iv.starts[order], iv.ends[order], iv.blocks[order]
    runmax = np.maximum.accumulate(e)
    idx = np.arange(s.shape[0])
    holder = np.maximum.accumulate(np.where(e == runmax, idx, -1))
    hit = (s[1:] < runmax[:-1]) & (b[1:] != b[holder[:-1]])
    if not hit.any():
        return None
    i = int(np.flatnonzero(hit)[0]) + 1
    return int(s[i]), int(b[holder[i - 1]]), int(b[i])


def _merged(parts: list):
    """The union of a list of ``Intervals`` as sorted disjoint segments."""
    iv = meta.Intervals.cat(parts)
    if iv.starts.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(iv.starts, kind="stable")
    s, e = iv.starts[order], iv.ends[order]
    runmax = np.maximum.accumulate(e)
    new = np.ones(s.shape[0], bool)
    new[1:] = s[1:] > runmax[:-1]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, s.shape[0] - 1]
    return s[first], runmax[last]


def _uncovered(reads: meta.Intervals, parts: list):
    """The first element of ``reads`` that no interval of ``parts`` holds, or
    None."""
    if reads.starts.shape[0] == 0:
        return None
    seg_s, seg_e = _merged(parts)
    if seg_s.shape[0] == 0:
        return int(reads.starts.min())
    k = np.searchsorted(seg_s, reads.starts, side="right") - 1
    held = k >= 0
    ok = held & (seg_e[np.maximum(k, 0)] >= reads.ends)
    if ok.all():
        return None
    i = int(np.flatnonzero(~ok)[0])
    return int(reads.starts[i]) if not held[i] or seg_e[k[i]] <= reads.starts[i] \
        else int(seg_e[k[i]])


def _derived_kind(grid: int, writes: dict, reads: dict, later_reads: set) -> str:
    if grid == 1:
        return "single-block"
    if any(buf in writes for buf in reads):
        return "ticket"
    if any(buf in later_reads for buf in writes):
        return "split-partials"
    return "per-block"


def analyze_call(call, *, sms: int = meta.H100_SMS, kernels: dict | None = None,
                 wrappers: dict | None = None, target: str = "<anonymous>") -> list[Finding]:
    """Race-lint one recorded wrapper call (``kernels.ops.WrapperCall``).
    ``kernels`` / ``wrappers`` replace the registered declarations (the
    known-bad seeds); ``sms`` is used where the call did not run on a card."""
    kernels = meta.KERNEL_GEOMETRY if kernels is None else kernels
    wrappers = meta.WRAPPER_GEOMETRY if wrappers is None else wrappers
    where = f"{target}:{call.name}"
    wdecl = wrappers.get(call.name)
    if wdecl is None:
        return [error("grid-race", where, f"wrapper {call.name!r} has no declared geometry "
                      "in kernels.meta")]
    p = dict(call.params)
    p.setdefault("sms", sms)
    bufs = wdecl.buffers(p)
    findings: list[Finding] = []
    plan = []
    for launch in wdecl.launches(p):
        decl = kernels.get(launch.kernel)
        if decl is None:
            findings.append(error("grid-race", where, f"kernel {launch.kernel!r} has no "
                                  "declared geometry in kernels.meta"))
            continue
        grid = int(decl.grid(launch.params))
        plan.append((launch, decl, grid, decl.writes(launch.params, grid),
                     decl.reads(launch.params) if decl.reads else {},
                     decl.last_writes(launch.params) if decl.last_writes else {}))
    written: dict = {buf: [] for buf in bufs}
    for li, (launch, decl, grid, writes, reads, last) in enumerate(plan):
        name = f"{launch.kernel} (grid {grid}, {call.name} K={p.get('K')} D={p.get('D')})"
        for buf, iv in list(writes.items()) + list(last.items()):
            if buf not in bufs:
                findings.append(error("grid-race", where, f"{name}: writes {buf!r}, which "
                                      "the wrapper does not allocate"))
                continue
            size = bufs[buf][0]
            if iv.starts.shape[0] and (iv.starts.min() < 0 or iv.ends.max() > size):
                findings.append(error("grid-race", where, f"{name}: writes {buf!r} outside "
                                      f"its {size} elements"))
        for buf, iv in writes.items():
            hit = _overlap(iv)
            if hit is not None:
                findings.append(error(
                    "grid-race", where,
                    f"{name}: element {hit[0]} of {buf!r} is written by blocks {hit[1]} and "
                    f"{hit[2]} — a race between blocks that run in parallel"))
        for buf, iv in reads.items():
            parts = written.get(buf, []) + ([writes[buf]] if buf in writes else [])
            gap = _uncovered(iv, parts)
            if gap is not None:
                findings.append(error(
                    "grid-race", where,
                    f"{name}: reads element {gap} of {buf!r}, which no block wrote before"))
        later = {buf for _, _, _, _, r, _ in plan[li + 1:] for buf in r}
        derived = _derived_kind(grid, writes, reads, later)
        if decl.accumulation == "single-block" and grid > 1:
            findings.append(error("grid-race", where, f"{name}: declared 'single-block' but "
                                  f"launched with {grid} blocks"))
        elif derived != "single-block" and derived != decl.accumulation:
            findings.append(error(
                "grid-race", where,
                f"{name}: declared {decl.accumulation!r} but its write map shows "
                f"{derived!r} — the declaration in kernels.meta does not hold"))
        for buf, iv in list(writes.items()) + list(last.items()):
            written.setdefault(buf, []).append(iv)
    for buf, (size, role) in bufs.items():
        if role != "out":
            continue
        gap = _uncovered(meta.Intervals.span(0, size), written.get(buf, []))
        if gap is not None:
            findings.append(error("grid-race", where, f"{call.name}: element {gap} of the "
                                  f"returned {buf!r} is never written"))
    return findings


def analyze_kernel_races(fn_or_calls: Any, *args: Any, sms: int = meta.H100_SMS,
                         target: str = "<anonymous>", kernels: dict | None = None,
                         wrappers: dict | None = None) -> list[Finding]:
    """Race-lint every wrapper call of one ``fn(*args)`` (recorded here), or
    of a list of recorded calls."""
    calls = record(fn_or_calls, *args)[1].calls if callable(fn_or_calls) else fn_or_calls
    findings: list[Finding] = []
    for call in calls:
        findings.extend(analyze_call(call, sms=sms, kernels=kernels, wrappers=wrappers,
                                     target=target))
    return list(dict.fromkeys(findings))


# ---------------------------------------------------------------------------
# the source pass
# ---------------------------------------------------------------------------


def _strip_comments(text: str) -> str:
    """The source with comments blanked, newlines kept (line numbers hold)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))

    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


def _balanced(text: str, start: int, open_ch: str, close_ch: str) -> int:
    """The index just past the bracket that closes the one at ``start``."""
    depth = 0
    for i in range(start, len(text)):
        if text[i] == open_ch:
            depth += 1
        elif text[i] == close_ch:
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


def global_kernels(text: str) -> list:
    """``(name, body, line)`` of every ``__global__`` function of a source
    (comments stripped)."""
    out = []
    for m in re.finditer(r"\b__global__\b", text):
        brace = text.find("{", m.end())
        head = text[m.end():brace]
        lb = head.find("__launch_bounds__")
        if lb >= 0:
            paren = head.find("(", lb)
            head = head[:lb] + head[_balanced(head, paren, "(", ")"):]
        name = re.search(r"\b(\w+)\s*\(", head)
        if name is None or brace < 0:
            continue
        out.append((name.group(1), text[brace:_balanced(text, brace, "{", "}")],
                    text.count("\n", 0, m.start()) + 1))
    return out


def _float_atomics(text: str) -> list:
    """``(line, call)`` of every atomic add on a floating type."""
    hits = []
    for m in re.finditer(r"\b(atomicAdd|atomicAdd_block|atomicAdd_system|unsafeAtomicAdd|"
                         r"atomicSub)\s*\(", text):
        end = _balanced(text, m.end() - 1, "(", ")")
        args = text[m.end():end - 1]
        depth, cut = 0, len(args)
        for i, ch in enumerate(args):
            depth += ch in "([{"
            depth -= ch in ")]}"
            if ch == "," and depth == 0:
                cut = i
                break
        first, second = args[:cut], args[cut + 1:]
        base = re.search(r"[A-Za-z_]\w*", first.replace("reinterpret_cast", ""))
        ftype = None
        if base is not None:
            decls = list(re.finditer(
                r"\b([A-Za-z_]\w*)\s*(?:const\s*)?\*+\s*(?:const\s+)?(?:__restrict__\s+)?"
                + re.escape(base.group(0)) + r"\b|\b([A-Za-z_]\w*)\s+"
                + re.escape(base.group(0)) + r"\s*\[", text[:m.start()]))
            if decls:
                ftype = decls[-1].group(1) or decls[-1].group(2)
        literal = re.fullmatch(r"\s*[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?[fF]?\s*", second)
        if ftype in FLOAT_TYPES or (literal and re.search(r"[.eE]|[fF]$", second.strip())):
            hits.append((text.count("\n", 0, m.start()) + 1, text[m.start():end].strip()))
    for m in re.finditer(r"\b(red|atom)(\.\w+)*\.add(\.\w+)*\.(f16|bf16|f32|f64)\b", text):
        hits.append((text.count("\n", 0, m.start()) + 1, m.group(0)))
    return hits


def _ticket_findings(path: str, text: str, ticket_kernels: dict) -> list[Finding]:
    findings = []
    lb = re.search(r"\bstruct\s+LastBlock\b", text)
    lb_body = text[lb.start():_balanced(text, text.find("{", lb.end()), "{", "}")] if lb else ""
    draw = re.search(r"\bdraw\s*\(\s*\)\s*(const\s*)?\{", lb_body)
    release = re.search(r"\brelease\s*\(\s*\)\s*(const\s*)?\{", lb_body)
    for name, (body, line) in ticket_kernels.items():
        where = f"{path}:{line}:{name}"
        if ".draw()" not in body or ".release()" not in body:
            findings.append(error("grid-race", where, "a ticket kernel must draw its ticket "
                                  "through LastBlock::draw() and call release() when done"))
            continue
        if draw is None or release is None:
            findings.append(error("grid-race", where, "no LastBlock with draw() and release() "
                                  "in the source"))
            continue
        d = lb_body[draw.end() - 1:_balanced(lb_body, draw.end() - 1, "{", "}")]
        fences = [f.start() for f in re.finditer(r"__threadfence\s*\(\s*\)", d)]
        atomic = re.search(r"\batomicAdd\s*\(", d)
        if atomic is None or not fences or min(fences) > atomic.start() \
                or max(fences) < atomic.start():
            findings.append(error("grid-race", where, "LastBlock::draw() must fence "
                                  "(__threadfence) before and after its atomicAdd"))
        r = lb_body[release.end() - 1:_balanced(lb_body, release.end() - 1, "{", "}")]
        if not re.search(r"\*\s*ticket\s*=\s*0", r):
            findings.append(error("grid-race", where, "LastBlock::release() must set the "
                                  "counter back to 0 for the next launch on the stream"))
    return findings


def check_sources(sources: dict | None = None, *, kernels: dict | None = None) -> list[Finding]:
    """The source pass over ``{path: text}`` (``csrc/*.cu`` by default)."""
    kernels = meta.KERNEL_GEOMETRY if kernels is None else kernels
    if sources is None:
        sources = {f"csrc/{p.name}": p.read_text() for p in sorted(CSRC.glob("*.cu"))}
    findings: list[Finding] = []
    for path, raw in sources.items():
        text = _strip_comments(raw)
        for line, call in _float_atomics(text):
            findings.append(error("grid-race", f"{path}:{line}",
                                  f"float atomic {call!r}: the port keeps no float atomics "
                                  "(sums in a fixed order, bit-identical reruns)"))
        found = global_kernels(text)
        for name, _, line in found:
            if name not in kernels:
                findings.append(warning("grid-race", f"{path}:{line}",
                                        f"__global__ {name} has no declared geometry in "
                                        "kernels.meta"))
        tickets = {name: (body, line) for name, body, line in found
                   if name in kernels and kernels[name].accumulation == "ticket"}
        findings.extend(_ticket_findings(path, text, tickets))
    return findings
