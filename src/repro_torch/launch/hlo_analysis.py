"""Structure-aware HLO cost analysis for the roofline. A copy of
``repro/launch/hlo_analysis.py`` (which imports no JAX), with the card's
roofline constants: the H100 SXM's datasheet peaks, in place of the TPU
constants the JAX package uses. The port's dry run (``launch/dryrun.py``)
fills ``Roofline`` from its own counts with the same constants.

XLA's built-in ``compiled.cost_analysis()`` visits every instruction ONCE —
it does NOT multiply `while` bodies by their trip counts (verified
empirically), so for scan-over-layers models it undercounts FLOPs by ~L and
misses every collective inside the loop. This module parses the post-SPMD
HLO text, builds the computation call graph, extracts static trip counts
from loop conditions, and accumulates three per-device roofline terms:

  * flops            — dot-op FLOPs (2*M*N*K); elementwise ops are ignored
                       (matmul-dominated workloads; documented in
                       EXPERIMENTS.md §Roofline methodology).
  * mem_bytes        — operand+result bytes of top-level ops per
                       computation (fusion internals excluded), an
                       HBM-traffic estimate in the XLA "bytes accessed"
                       sense.
  * collective_bytes — wire bytes of all-gather / all-reduce /
                       reduce-scatter / all-to-all / collective-permute
                       with ring-transport factors:
                         all-reduce        2*(N-1)/N * bytes
                         all-gather        (N-1)/N * result bytes
                         reduce-scatter    (N-1)/N * operand bytes
                         all-to-all        (N-1)/N * bytes
                         collective-permute       bytes
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "tuple": 0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")


def shape_bytes(type_str: str) -> int:
    """Total bytes of an HLO type string (handles tuples)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def shape_dims(type_str: str) -> Tuple[str, List[int]]:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return "", []
    dims = [int(d) for d in m.group(1 + 1).split(",") if d]
    return m.group(1), dims


@dataclasses.dataclass
class Instruction:
    name: str
    result_type: str
    opcode: str
    raw: str


@dataclasses.dataclass
class Computation:
    name: str
    instructions: List[Instruction]
    is_entry: bool = False
    is_fusion: bool = False


_COMP_HEAD = re.compile(
    r"^(ENTRY\s+)?%?([\w\.\-]+)\s*\(.*->")
_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*((?:\(.*?\)|[\w\[\],\{\}]+?))\s+"
    r"([\w\-]+)\(")


def parse_computations(hlo: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in hlo.splitlines():
        stripped = line.strip()
        head = _COMP_HEAD.match(stripped)
        if head and stripped.endswith("{"):
            cur = Computation(head.group(2), [],
                              is_entry=bool(head.group(1)))
            comps[cur.name] = cur
            continue
        if stripped.startswith("}"):
            # keep cur set only within a computation body
            if cur is not None and stripped == "}":
                cur = None
            continue
        if cur is None:
            continue
        m = _INSTR.match(line)
        if m:
            cur.instructions.append(
                Instruction(m.group(1), m.group(2), m.group(3), line))
    return comps


_CALLED = re.compile(
    r"(?:body|condition|to_apply|calls|branch_computations)="
    r"(?:%?([\w\.\-]+)|\{([^\}]*)\})")
_CONST_INT = re.compile(r"\bconstant\((\d+)\)")
_GROUPS_NEW = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_GROUPS_OLD = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


def called_computations(instr: Instruction) -> List[str]:
    out: List[str] = []
    for m in _CALLED.finditer(instr.raw):
        if m.group(1):
            out.append(m.group(1))
        else:
            for part in m.group(2).split(","):
                part = part.strip().lstrip("%")
                if part:
                    out.append(part)
    return out


_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')


def while_trip_count(instr: Instruction,
                     comps: Dict[str, Computation]) -> int:
    """Static trip count: backend_config's known_trip_count when present,
    else the loop condition's compare constant."""
    m = _TRIP.search(instr.raw)
    if m:
        return int(m.group(1))
    m = re.search(r"condition=%?([\w\.\-]+)", instr.raw)
    if not m or m.group(1) not in comps:
        return 1
    cond = comps[m.group(1)]
    best = 1
    for ins in cond.instructions:
        for c in _CONST_INT.finditer(ins.raw):
            best = max(best, int(c.group(1)))
    return best


def group_size(instr: Instruction, n_devices: int) -> int:
    m = _GROUPS_NEW.search(instr.raw)
    if m:
        num_groups = int(m.group(1))
        per_group = int(m.group(2))
        return per_group if per_group > 0 else n_devices
    m = _GROUPS_OLD.search(instr.raw)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip()])
    return n_devices


_DOT_DNUMS = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_ARG_SPLIT = re.compile(r"\(([^()]*(?:\([^()]*\)[^()]*)*)\)")


def operand_tokens(instr: Instruction) -> List[str]:
    """Raw operand tokens of an instruction's call-site argument list.

    Modern XLA prints each operand with its inline type, e.g.
    ``dot(f32[64,128]{1,0} %lhs, f32[128,128]{1,0} %rhs)``, so commas inside
    ``[dims]`` / ``{layout}`` must not split tokens — only top-level commas
    of the argument list do.
    """
    # args start right after "opcode("
    idx = instr.raw.find(instr.opcode + "(")
    if idx < 0:
        return []
    args = instr.raw[idx + len(instr.opcode) + 1:]
    depth = 1           # parentheses (tuple types, nested calls)
    bracket = 0         # [dims] and {layout}/{replica groups}
    out = []
    cur = []
    for ch in args:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                break
        elif ch in "[{":
            bracket += 1
        elif ch in "]}":
            bracket -= 1
        if ch == "," and depth == 1 and bracket == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


def operand_name(token: str) -> str:
    """Instruction name referenced by an operand token ("" if literal).

    Handles both bare references (``%p0`` / ``p0``) and the inline-typed
    form (``f32[64]{0} %p0``).
    """
    if "%" in token:
        return token[token.rindex("%") + 1:].split(" ")[0].strip()
    if "[" in token:   # inline type without a %name: no reference
        return ""
    return token.strip().split(" ")[0]


def operand_type(token: str, types: Dict[str, str]) -> str:
    """Type of one operand token: inline type or name lookup."""
    if "[" in token:
        return token
    return types.get(operand_name(token), "")


def _elem_count(type_str: str) -> int:
    n = 0
    for _, dims in _SHAPE_RE.findall(type_str):
        c = 1
        for d in dims.split(","):
            if d:
                c *= int(d)
        n += c
    return n


def narrow_bytes(token: str, comp: "Computation",
                 types: Dict[str, str]) -> int:
    """Bytes of an operand at its NATIVE width.

    The CPU backend upcasts bf16 dot inputs to f32 (`convert` /
    `convert_*_fusion` feeding the dot or collective); a TPU moves the
    bf16 tensor natively. When the operand is such a widening convert of
    a same-element-count narrower tensor, count the narrower size —
    otherwise the roofline's memory/collective terms are 2x inflated for
    every bf16 model (EXPERIMENTS.md §Roofline methodology).
    """
    t = operand_type(token, types)
    name = operand_name(token)
    if not name:
        return shape_bytes(t)
    src = next((i for i in comp.instructions if i.name == name), None)
    if src is None or "convert" not in (src.name + src.opcode):
        return shape_bytes(t)
    n_out = _elem_count(t)
    best = shape_bytes(t)
    for tok in operand_tokens(src):
        ot = operand_type(tok, types)
        if ot and _elem_count(ot) == n_out:
            best = min(best, shape_bytes(ot))
    return best


def dot_flops(instr: Instruction, types: Dict[str, str]) -> float:
    """2 * result_elements * K for a dot op."""
    _, rdims = shape_dims(instr.result_type)
    result_elems = 1
    for d in rdims:
        result_elems *= d
    ops = operand_tokens(instr)
    if not ops:
        return 0.0
    _, lhs_dims = shape_dims(operand_type(ops[0], types))
    m = _DOT_DNUMS.search(instr.raw)
    k = 1
    if m and m.group(1):
        for idx in m.group(1).split(","):
            if idx and int(idx) < len(lhs_dims):
                k *= lhs_dims[int(idx)]
    return 2.0 * result_elems * k


_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0
    mem_bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    n_collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    mem_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add_mem(self, op: str, nbytes: float) -> None:
        self.mem_bytes += nbytes
        self.mem_by_op[op] = self.mem_by_op.get(op, 0.0) + nbytes

    def add(self, other: "CostTotals", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.mem_bytes += other.mem_bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        for k, v in other.per_collective.items():
            self.per_collective[k] = self.per_collective.get(k, 0) + v * mult
        for k, v in other.n_collectives.items():
            self.n_collectives[k] = self.n_collectives.get(k, 0) + int(
                v * mult)
        for k, v in other.mem_by_op.items():
            self.mem_by_op[k] = self.mem_by_op.get(k, 0.0) + v * mult


def _collective_wire_bytes(instr: Instruction, n_devices: int,
                           comp: Optional["Computation"] = None,
                           types: Optional[Dict[str, str]] = None) -> float:
    N = max(2, group_size(instr, n_devices))
    out_b = float(shape_bytes(instr.result_type))
    # native-width operand bytes (undoes the CPU backend's bf16->f32
    # upcast before dots/collectives; a TPU moves bf16 natively)
    op_b: Optional[float] = None
    if comp is not None and types is not None:
        ops = operand_tokens(instr)
        if ops:
            op_b = float(sum(narrow_bytes(t, comp, types) for t in ops))
    frac = (N - 1) / N
    if instr.opcode.startswith("all-reduce"):
        base = min(out_b, op_b) if op_b else out_b
        return 2.0 * frac * base
    if instr.opcode.startswith("all-gather"):
        full = min(out_b, op_b * N) if op_b else out_b
        return frac * full
    if instr.opcode.startswith("reduce-scatter"):
        full = min(out_b * N, op_b) if op_b else out_b * N
        return frac * full
    if instr.opcode.startswith("all-to-all"):
        base = min(out_b, op_b) if op_b else out_b
        return frac * base
    base = min(out_b, op_b) if op_b else out_b
    return base  # collective-permute


def _dus_update_type(instr: Instruction,
                     comps: Dict[str, Computation]) -> Optional[str]:
    """If ``instr`` is a fusion whose root is dynamic-update-slice, return
    the update operand's type (the bytes actually moved)."""
    m = re.search(r"calls=%?([\w\.\-]+)", instr.raw)
    if not m or m.group(1) not in comps:
        return None
    body = comps[m.group(1)]
    if not body.instructions:
        return None
    root = body.instructions[-1]
    for i in body.instructions:
        if "ROOT" in i.raw.lstrip()[:6]:
            root = i
            break
    if not root.opcode.startswith("dynamic-update-slice"):
        return None
    types = {i.name: i.result_type for i in body.instructions}
    ops = operand_tokens(root)
    if len(ops) >= 2:
        return operand_type(ops[1], types)
    return None


def analyze_hlo(hlo: str, n_devices: int) -> CostTotals:
    comps = parse_computations(hlo)
    memo: Dict[str, CostTotals] = {}

    def cost_of(name: str, stack: Tuple[str, ...] = ()) -> CostTotals:
        if name in memo:
            return memo[name]
        if name not in comps or name in stack:
            return CostTotals()
        comp = comps[name]
        types = {i.name: i.result_type for i in comp.instructions}
        total = CostTotals()
        for ins in comp.instructions:
            op = ins.opcode
            if op.endswith("-start"):
                base = op[:-len("-start")]
            elif op.endswith("-done"):
                base = op[:-len("-done")]
            else:
                base = op
            if base.startswith("dot"):
                total.flops += dot_flops(ins, types)
                # write result + read both operands (weight reads are the
                # point: they are loop-carried and never "produced");
                # operands counted at native width (bf16 on TPU even when
                # the CPU backend upcasts them to f32 for the dot)
                total.add_mem("dot", 2 * shape_bytes(ins.result_type))
                for tok in operand_tokens(ins):
                    total.add_mem("dot", narrow_bytes(tok, comp, types))
            elif any(base.startswith(c) for c in _COLLECTIVES):
                if op.endswith("-done"):
                    continue  # counted at -start
                wb = _collective_wire_bytes(ins, n_devices, comp, types)
                total.collective_bytes += wb
                key = next(c for c in _COLLECTIVES if base.startswith(c))
                total.per_collective[key] = total.per_collective.get(
                    key, 0.0) + wb
                total.n_collectives[key] = total.n_collectives.get(
                    key, 0) + 1
            elif base == "fusion" or base == "custom-call":
                # in-place carry updates (DUS-root fusions) move only the
                # update slice, not the whole buffer
                dus = _dus_update_type(ins, comps)
                if dus is not None:
                    total.add_mem("dus", 2 * shape_bytes(dus))
                else:
                    total.add_mem(base, 2 * shape_bytes(ins.result_type))
            elif base == "dynamic-update-slice":
                ops = operand_tokens(ins)
                if len(ops) >= 2:
                    total.add_mem("dus", 2 * shape_bytes(
                        operand_type(ops[1], types)))
            elif base in ("copy", "transpose",
                          "dynamic-slice", "concatenate", "sort",
                          "scatter", "gather", "reduce", "convert",
                          "broadcast", "select", "compare",
                          "add", "multiply", "subtract", "divide",
                          "exponential", "tanh", "rsqrt", "pad", "slice"):
                total.add_mem(base, 2 * shape_bytes(ins.result_type))
            if base == "while":
                trips = while_trip_count(ins, comps)
                body = re.search(r"body=%?([\w\.\-]+)", ins.raw)
                cond = re.search(r"condition=%?([\w\.\-]+)", ins.raw)
                if body:
                    total.add(cost_of(body.group(1), stack + (name,)),
                              trips)
                if cond:
                    total.add(cost_of(cond.group(1), stack + (name,)),
                              trips)
            elif base not in ("fusion",):  # fusion internals are free
                for sub in called_computations(ins):
                    total.add(cost_of(sub, stack + (name,)))
        memo[name] = total
        return total

    entry = next((c.name for c in comps.values() if c.is_entry), None)
    if entry is None:
        return CostTotals()
    return cost_of(entry)


# --------------------------------------------------------------- roofline --
#: NVIDIA H100 SXM datasheet peaks (per GPU), not measured: dense bf16
#: tensor-core FLOP/s, HBM3 bytes/s, and NVLink 4 bytes/s per direction
PEAK_FLOPS = 989e12      # bf16 FLOP/s, datasheet
HBM_BW = 3.35e12         # bytes/s, datasheet
ICI_BW = 450e9           # NVLink 4 bytes/s per direction, datasheet


@dataclasses.dataclass
class Roofline:
    """Three per-step roofline terms, in seconds (per device)."""

    compute_s: float
    memory_s: float
    collective_s: float
    totals: CostTotals
    model_flops_per_dev: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_fraction(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs (remat/redundancy waste detector)."""
        if self.totals.flops <= 0:
            return 0.0
        return self.model_flops_per_dev / self.totals.flops

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of compute roofline: compute / max(all)."""
        if self.bound_s <= 0:
            return 0.0
        return self.compute_s / self.bound_s


def roofline_from_hlo(hlo: str, n_devices: int,
                      model_flops_global: float = 0.0) -> Roofline:
    t = analyze_hlo(hlo, n_devices)
    return Roofline(
        compute_s=t.flops / PEAK_FLOPS,
        memory_s=t.mem_bytes / HBM_BW,
        collective_s=t.collective_bytes / ICI_BW,
        totals=t,
        model_flops_per_dev=model_flops_global / max(n_devices, 1))
