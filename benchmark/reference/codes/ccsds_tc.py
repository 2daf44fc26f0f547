"""The CCSDS telecommand (TC) LDPC codes, written from the standards.

CCSDS 231.0-B-3, TC Synchronization and Channel Coding, and CCSDS 231.1-O-1,
Short Block Length LDPC Codes for TC Synchronization and Channel Coding: the
rate-1/2 codes (n, k) = (128, 64), (256, 128) and (512, 256). H is a 4 x 8
block matrix of M x M blocks, M = n / 8, with I_M + Φ^k on the diagonal of
the first four block columns; Φ is the first right circular shift of I_M,
so Φ^k has its ones at row r, column (r + k) mod M.
"""

from __future__ import annotations

from benchmark.reference.code import QCCode, from_blocks

# block (i, j): 'I+Pk' is I_M + Φ^k, 'Pk' is Φ^k, 'I' is I_M, '0' is 0_M
H = {
    128: """\
 I+P7    P2    P14   P6    0     P0    P13   I
 P6      I+P15 P0    P1    I     0     P0    P7
 P4      P1    I+P15 P14   P11   I     0     P3
 P0      P1    P9    I+P13 P14   P1    I     0
""",
    256: """\
 I+P31   P15   P25   P0    0     P20   P12   I
 P28     I+P30 P29   P24   I     0     P1    P20
 P8      P0    I+P28 P1    P29   I     0     P21
 P18     P30   P0    I+P30 P25   P26   I     0
""",
    512: """\
 I+P63   P30   P50   P25   0     P43   P62   I
 P56     I+P61 P50   P23   I     0     P37   P26
 P16     P0    I+P55 P27   P56   I     0     P43
 P35     P56   P62   I+P11 P58   P3    I     0
""",
}


def _shifts(block: str) -> tuple[int, ...]:
    """The circulants' shifts of one block, I_M (shift 0) first."""
    return tuple(0 if t == "I" else int(t[1:])
                 for t in block.split("+") if t != "0")


def build(code: dict) -> QCCode:
    n = code["n"]
    if n not in H:
        raise SystemExit(f"no CCSDS TC code of length {n} "
                         f"(have {', '.join(map(str, H))})")
    return from_blocks([[_shifts(b) for b in line.split()]
                        for line in H[n].strip().splitlines()], n // 8)
