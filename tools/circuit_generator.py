"""Offline straight-line circuit generator for bit-sliced tower multiply.

The JAX library's equivalent of the reference's codegen tool
(src/ulvt/finite_fields/circuit_generator/multiply_and_generate_circuit.cpp:10-242),
which symbolically executes the Karatsuba tower recursion over word addresses
and emits ~30k lines of straight-line CUDA XOR/AND statements.

Here the same symbolic execution produces:
  * an op list (op, dst, a, b) — exactly 3^h ANDs plus XOR/copy glue;
  * a generated Python source string evaluating the circuit over any array
    namespace — usable as an unrolled kernel body (each statement is one
    elementwise op) or as an independent cross-check of
    fields/bitsliced.py (which evaluates the same recursion level-
    synchronously instead of materialising the statements).

Run as a script to write generated/bitsliced_mul_h{H}.py.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

sys.setrecursionlimit(10000)


@dataclass
class Circuit:
    """Symbolic evaluator; values are SSA ids, ops are recorded."""

    ops: list = field(default_factory=list)   # ("and"|"xor", dst, a, b)
    n_vals: int = 0

    def new(self) -> int:
        self.n_vals += 1
        return self.n_vals - 1

    def band(self, a: int, b: int) -> int:
        d = self.new()
        self.ops.append(("and", d, a, b))
        return d

    def bxor(self, a: int, b: int) -> int:
        d = self.new()
        self.ops.append(("xor", d, a, b))
        return d


def _mul(c: Circuit, a: list[int], b: list[int], height: int) -> list[int]:
    """Karatsuba recursion over symbolic bit-planes.

    cf. VarTable::multiply (multiply_and_generate_circuit.cpp:86-155) and
    generic_multiply (binary_tower.cuh:35-50).
    """
    if height == 0:
        return [c.band(a[0], b[0])]
    half = 1 << (height - 1)
    a0, a1 = a[:half], a[half:]
    b0, b1 = b[:half], b[half:]
    z0 = _mul(c, a0, b0, height - 1)
    z2 = _mul(c, a1, b1, height - 1)
    am = [c.bxor(x, y) for x, y in zip(a0, a1)]
    bm = [c.bxor(x, y) for x, y in zip(b0, b1)]
    zm = _mul(c, am, bm, height - 1)
    z1 = [c.bxor(c.bxor(m, x), y) for m, x, y in zip(zm, z0, z2)]
    z2a = _mul_alpha(c, z2, height - 1)
    lo = [c.bxor(x, y) for x, y in zip(z0, z2)]
    hi = [c.bxor(x, y) for x, y in zip(z1, z2a)]
    return lo + hi


def _mul_alpha(c: Circuit, x: list[int], height: int) -> list[int]:
    """cf. VarTable::multiply_alpha (:62-84) / generic_multiply_alpha."""
    if height == 0:
        return [x[0]]
    half = 1 << (height - 1)
    x0, x1 = x[:half], x[half:]
    t = _mul_alpha(c, x1, height - 1)
    return list(x1) + [c.bxor(u, v) for u, v in zip(x0, t)]


def generate(height: int):
    """Returns (circuit, input_a_ids, input_b_ids, output_ids)."""
    c = Circuit()
    w = 1 << height
    a = [c.new() for _ in range(w)]
    b = [c.new() for _ in range(w)]
    out = _mul(c, a, b, height)
    return c, a, b, out


def emit_python(height: int) -> str:
    """Emit a straight-line Python function multiplying bit-sliced planes.

    The body is pure elementwise AND/XOR statements — directly usable as a
    kernel body (each v{i} is a whole plane vector).
    """
    c, a, b, out = generate(height)
    w = 1 << height
    lines = [
        f"# GENERATED by tools/circuit_generator.py (height={height});",
        f"# {sum(1 for o in c.ops if o[0] == 'and')} ANDs, "
        f"{sum(1 for o in c.ops if o[0] == 'xor')} XORs.",
        f"def multiply_unrolled_h{height}(a, b):",
        f"    # a, b: sequences of {w} bit-plane arrays; returns list of {w}.",
    ]
    names = {}
    for i, vid in enumerate(a):
        names[vid] = f"a[{i}]"
    for i, vid in enumerate(b):
        names[vid] = f"b[{i}]"
    sym = {"and": "&", "xor": "^"}
    for op, dst, x, y in c.ops:
        names[dst] = f"v{dst}"
        lines.append(f"    v{dst} = {names[x]} {sym[op]} {names[y]}")
    lines.append("    return [" + ", ".join(names[o] for o in out) + "]")
    return "\n".join(lines) + "\n"


def main():
    import pathlib

    height = int(sys.argv[1]) if len(sys.argv) > 1 else 7
    outdir = pathlib.Path(__file__).parent / "generated"
    outdir.mkdir(exist_ok=True)
    path = outdir / f"bitsliced_mul_h{height}.py"
    path.write_text(emit_python(height))
    c, *_ = generate(height)
    n_and = sum(1 for o in c.ops if o[0] == "and")
    print(f"wrote {path} ({n_and} ANDs == 3^{height} == {3 ** height})")


if __name__ == "__main__":
    main()
