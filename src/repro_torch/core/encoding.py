"""Bit-exact xmnmc instruction encoding (own copy of the part of
repro.core.encoding and repro.core.isa that the engine's trace needs).

Instruction word layout (R4-type, RISC-V Custom-2 major opcode 0x5b)::

    31    27 26  25 24   20 19   15 14    12 11   7 6      0
    [func5 ] [fmt ] [ rs2  ] [ rs1  ] [funct3] [ rd ] [opcode]
      kernel   0b10    reg      reg     width    reg    0x5b

The three source registers carry 16-bit (hi, lo) halves: for ``xmkN``
hi(rs1)=alpha lo(rs1)=beta hi(rs2)=ms3 lo(rs2)=md hi(rs3)=ms1 lo(rs3)=ms2,
with alpha/beta as signed Q8.8 fixed point. The words must stay identical to
the reference encoder's.
"""
from __future__ import annotations

import dataclasses
import enum

OPCODE_CUSTOM2 = 0x5B
FMT_XMNMC = 0b10

XMR_FUNC5 = 31
NUM_XMK = 31
NUM_MATRIX_REGS = 32
Q = 8                   # fractional bits of the Q8.8 scalars


class ElemWidth(enum.IntEnum):
    """Element width suffix — funct3 encoding."""

    W = 0  # 32-bit
    H = 1  # 16-bit
    B = 2  # 8-bit

    @property
    def suffix(self) -> str:
        return ("w", "h", "b")[int(self)]


def _check_range(name: str, value: int, lo: int, hi: int) -> None:
    if not lo <= value <= hi:
        raise ValueError(f"{name}={value} out of range [{lo}, {hi}]")


@dataclasses.dataclass(frozen=True)
class InstrWord:
    """Decoded fields of one 32-bit xmnmc instruction word."""

    func5: int
    width: ElemWidth
    rs1: int = 10  # a0
    rs2: int = 11  # a1
    rd: int = 10   # a0

    def encode(self) -> int:
        for name in ("func5", "rs1", "rs2", "rd"):
            _check_range(name, getattr(self, name), 0, 31)
        return ((self.func5 << 27) | (FMT_XMNMC << 25) | (self.rs2 << 20)
                | (self.rs1 << 15) | (int(self.width) << 12) | (self.rd << 7)
                | OPCODE_CUSTOM2)

    @classmethod
    def decode(cls, word: int) -> "InstrWord":
        _check_range("word", word, 0, 0xFFFFFFFF)
        if word & 0x7F != OPCODE_CUSTOM2:
            raise ValueError(f"opcode {word & 0x7F:#x} is not Custom-2 (0x5b)")
        if (word >> 25) & 0b11 != FMT_XMNMC:
            raise ValueError("fmt is not the xmnmc sub-space")
        funct3 = (word >> 12) & 0b111
        if funct3 > 2:
            raise ValueError(f"funct3 {funct3} is not a valid width suffix")
        return cls(func5=(word >> 27) & 0x1F, width=ElemWidth(funct3),
                   rs1=(word >> 15) & 0x1F, rs2=(word >> 20) & 0x1F,
                   rd=(word >> 7) & 0x1F)

    @property
    def mnemonic(self) -> str:
        base = "xmr" if self.func5 == XMR_FUNC5 else f"xmk{self.func5}"
        return f"{base}.{self.width.suffix}"


def _pack16(hi: int, lo: int) -> int:
    _check_range("hi", hi, 0, 0xFFFF)
    _check_range("lo", lo, 0, 0xFFFF)
    return (hi << 16) | lo


@dataclasses.dataclass(frozen=True)
class Operands:
    """The three 32-bit source-register values that travel with a word."""

    rs1: int
    rs2: int
    rs3: int


@dataclasses.dataclass(frozen=True)
class Offload:
    """One offloaded instruction: word + operand registers."""

    word: int
    operands: Operands

    @property
    def instr(self) -> InstrWord:
        return InstrWord.decode(self.word)


def encode_xmk(n: int, width: ElemWidth, md: int, ms1: int = 0, ms2: int = 0,
               ms3: int = 0, alpha: int = 0, beta: int = 0) -> Offload:
    _check_range("xmk index", n, 0, NUM_XMK - 1)
    for name, m in (("md", md), ("ms1", ms1), ("ms2", ms2), ("ms3", ms3)):
        _check_range(name, m, 0, NUM_MATRIX_REGS - 1)
    word = InstrWord(func5=n, width=width).encode()
    return Offload(word=word, operands=Operands(
        rs1=_pack16(alpha, beta), rs2=_pack16(ms3, md), rs3=_pack16(ms1, ms2)))


def fx_encode(x: float) -> int:
    """Encode a float scalar into the 16-bit Q8.8 operand half."""
    v = int(round(x * (1 << Q)))
    if not -0x8000 <= v <= 0x7FFF:
        raise ValueError(f"scalar {x} out of Q8.8 range")
    return v & 0xFFFF
