"""IEEE 802.16e LDPC codes, written from the standard.

IEEE Std 802.16e-2005, 8.4.9.2.5: a 12 x 24 base matrix of circulant shifts
at the largest lift z0 = 96; a code of length n = 24 z takes each shift p as
floor(p z / 96).
"""

from __future__ import annotations

from benchmark.reference.code import QCCode, from_blocks

# rate 1/2, shifts at z0 = 96 ('-' is the zero block)
RATE_HALF = """\
 -  94  73   -   -   -   -   -  55  83   -   -   7   0   -   -   -   -   -   -   -   -   -   -
 -  27   -   -   -  22  79   9   -   -   -  12   -   0   0   -   -   -   -   -   -   -   -   -
 -   -   -  24  22  81   -  33   -   -   -   0   -   -   0   0   -   -   -   -   -   -   -   -
61   -  47   -   -   -   -   -  65  25   -   -   -   -   -  0   0   -   -   -   -   -   -   -
 -   -  39   -   -   -  84   -   -  41  72   -   -   -   -   -   0   0   -   -   -   -   -   -
 -   -   -   -  46  40   -  82   -   -   -  79   0   -   -   -   -   0   0   -   -   -   -   -
 -   -  95  53   -   -   -   -   -  14  18   -   -   -   -   -   -   -   0   0   -   -   -   -
 -  11  73   -   -   -   2   -   -  47   -   -   -   -   -   -   -   -   -   0   0   -   -   -
12   -   -   -  83  24   -  43   -   -   -  51   -   -   -   -   -   -   -   -   0   0   -   -
 -   -   -   -   -  94   -  59   -   -  70  72   -   -   -   -   -   -   -   -   -   0   0   -
 -   -   7  65   -   -   -   -  39  49   -   -   -   -   -   -   -   -   -   -   -   -   0   0
43   -   -   -   -  66   -  41   -   -   -  26   7   -   -   -   -   -   -   -   -   -   -   0
"""
TABLES = {"1/2": RATE_HALF}
Z0 = 96


def wimax(n: int, rate: str = "1/2") -> QCCode:
    """The 802.16e code of length ``n`` (a multiple of 24, 576..2304)."""
    Z = n // 24
    return from_blocks([[() if cell == "-" else (int(cell) * Z // Z0,)
                         for cell in line.split()]
                        for line in TABLES[rate].strip().splitlines()], Z)


def build(code: dict) -> QCCode:
    return wimax(code["n"], code["rate"])
