"""Bit-exact xmnmc instruction encoding (RISC-V Custom-2 space, major opcode 0x5b).

Own copy of repro.core.encoding (and the Q8.8 scalar encoder of
repro.core.isa) for the engine's trace and the simulator's decoder.

Instruction word layout (R4-type, RISC-V Custom-2 major opcode 0x5b)::

    31    27 26  25 24   20 19   15 14    12 11   7 6      0
    [func5 ] [fmt ] [ rs2  ] [ rs1  ] [funct3] [ rd ] [opcode]
      kernel   0b10    reg      reg     width    reg    0x5b

``fmt`` = 0b10 marks the xmnmc sub-space; ``func5`` selects ``xmkN``
(N in [0, 30]) or ``xmr`` (31); ``funct3`` is the width suffix .w/.h/.b.
The three source registers carry 16-bit (hi, lo) halves (Table I): for
``xmr`` hi(rs1)=hi(&A) lo(rs1)=lo(&A) hi(rs2)=stride lo(rs2)=md
hi(rs3)=cols lo(rs3)=rows; for ``xmkN`` hi(rs1)=alpha lo(rs1)=beta
hi(rs2)=ms3 lo(rs2)=md hi(rs3)=ms1 lo(rs3)=ms2, with alpha/beta as signed
Q8.8 fixed point. The words must stay identical to the reference encoder's.
"""
from __future__ import annotations

import dataclasses
import enum

OPCODE_CUSTOM2 = 0x5B
FMT_XMNMC = 0b10

XMR_FUNC5 = 31          # xmr takes the code point outside xmkN, N in [0, 30]
NUM_XMK = 31            # xmk0 .. xmk30
NUM_MATRIX_REGS = 32    # logical matrix registers m0..m31
Q = 8                   # fractional bits of the Q8.8 scalars


class ElemWidth(enum.IntEnum):
    """Element width suffix — funct3 encoding."""

    W = 0  # 32-bit
    H = 1  # 16-bit
    B = 2  # 8-bit

    @property
    def nbytes(self) -> int:
        return (4, 2, 1)[int(self)]

    @property
    def suffix(self) -> str:
        return ("w", "h", "b")[int(self)]

    @classmethod
    def from_suffix(cls, s: str) -> "ElemWidth":
        return {"w": cls.W, "h": cls.H, "b": cls.B}[s]


def _check_range(name: str, value: int, lo: int, hi: int) -> None:
    if not lo <= value <= hi:
        raise ValueError(f"{name}={value} out of range [{lo}, {hi}]")


class IllegalInstruction(ValueError):
    """Raised by the decoder on a malformed word — the bridge replies 'reject'."""


@dataclasses.dataclass(frozen=True)
class InstrWord:
    """Decoded fields of one 32-bit xmnmc instruction word."""

    func5: int
    width: ElemWidth
    rs1: int = 10  # a0
    rs2: int = 11  # a1
    rd: int = 10   # a0 (decode outcome)

    def encode(self) -> int:
        for name in ("func5", "rs1", "rs2", "rd"):
            _check_range(name, getattr(self, name), 0, 31)
        return ((self.func5 << 27) | (FMT_XMNMC << 25) | (self.rs2 << 20)
                | (self.rs1 << 15) | (int(self.width) << 12) | (self.rd << 7)
                | OPCODE_CUSTOM2)

    @classmethod
    def decode(cls, word: int) -> "InstrWord":
        _check_range("word", word, 0, 0xFFFFFFFF)
        opcode = word & 0x7F
        if opcode != OPCODE_CUSTOM2:
            raise IllegalInstruction(f"opcode {opcode:#x} is not Custom-2 (0x5b)")
        fmt = (word >> 25) & 0b11
        if fmt != FMT_XMNMC:
            raise IllegalInstruction(f"fmt {fmt:#b} is not the xmnmc sub-space")
        funct3 = (word >> 12) & 0b111
        if funct3 > 2:
            raise IllegalInstruction(f"funct3 {funct3} is not a valid width suffix")
        return cls(func5=(word >> 27) & 0x1F, width=ElemWidth(funct3),
                   rs1=(word >> 15) & 0x1F, rs2=(word >> 20) & 0x1F,
                   rd=(word >> 7) & 0x1F)

    @property
    def is_xmr(self) -> bool:
        return self.func5 == XMR_FUNC5

    @property
    def mnemonic(self) -> str:
        base = "xmr" if self.is_xmr else f"xmk{self.func5}"
        return f"{base}.{self.width.suffix}"


def _pack16(hi: int, lo: int) -> int:
    _check_range("hi", hi, 0, 0xFFFF)
    _check_range("lo", lo, 0, 0xFFFF)
    return (hi << 16) | lo


def _unpack16(reg: int) -> tuple[int, int]:
    return (reg >> 16) & 0xFFFF, reg & 0xFFFF


@dataclasses.dataclass(frozen=True)
class Operands:
    """The three 32-bit source-register values that travel with a word.

    Which half means what is kernel-defined (Table I); the accessors follow
    the built-in kernels' conventions."""

    rs1: int
    rs2: int
    rs3: int

    # -- generic halves ----------------------------------------------------
    @property
    def hi1(self) -> int: return _unpack16(self.rs1)[0]
    @property
    def lo1(self) -> int: return _unpack16(self.rs1)[1]
    @property
    def hi2(self) -> int: return _unpack16(self.rs2)[0]
    @property
    def lo2(self) -> int: return _unpack16(self.rs2)[1]
    @property
    def hi3(self) -> int: return _unpack16(self.rs3)[0]
    @property
    def lo3(self) -> int: return _unpack16(self.rs3)[1]

    # -- xmr ---------------------------------------------------------------
    @classmethod
    def for_xmr(cls, addr: int, stride: int, md: int, cols: int,
                rows: int) -> "Operands":
        _check_range("addr", addr, 0, 0xFFFFFFFF)
        return cls(rs1=addr, rs2=_pack16(stride, md), rs3=_pack16(cols, rows))

    @property
    def xmr_addr(self) -> int: return self.rs1
    @property
    def xmr_stride(self) -> int: return self.hi2
    @property
    def xmr_md(self) -> int: return self.lo2
    @property
    def xmr_cols(self) -> int: return self.hi3
    @property
    def xmr_rows(self) -> int: return self.lo3

    # -- xmk (GeMM-style full form) ----------------------------------------
    @classmethod
    def for_xmk(cls, md: int, ms1: int = 0, ms2: int = 0, ms3: int = 0,
                alpha: int = 0, beta: int = 0) -> "Operands":
        return cls(rs1=_pack16(alpha, beta), rs2=_pack16(ms3, md),
                   rs3=_pack16(ms1, ms2))

    @property
    def alpha(self) -> int: return self.hi1
    @property
    def beta(self) -> int: return self.lo1
    @property
    def ms3(self) -> int: return self.hi2
    @property
    def md(self) -> int: return self.lo2
    @property
    def ms1(self) -> int: return self.hi3
    @property
    def ms2(self) -> int: return self.lo3


@dataclasses.dataclass(frozen=True)
class Offload:
    """One offloaded instruction as it crosses the CV-X-IF: word + operand regs."""

    word: int
    operands: Operands

    @property
    def instr(self) -> InstrWord:
        return InstrWord.decode(self.word)


def encode_xmr(width: ElemWidth, addr: int, stride: int, md: int, cols: int,
               rows: int) -> Offload:
    _check_range("md", md, 0, NUM_MATRIX_REGS - 1)
    word = InstrWord(func5=XMR_FUNC5, width=width).encode()
    return Offload(word=word,
                   operands=Operands.for_xmr(addr, stride, md, cols, rows))


def encode_xmk(n: int, width: ElemWidth, md: int, ms1: int = 0, ms2: int = 0,
               ms3: int = 0, alpha: int = 0, beta: int = 0) -> Offload:
    _check_range("xmk index", n, 0, NUM_XMK - 1)
    for name, m in (("md", md), ("ms1", ms1), ("ms2", ms2), ("ms3", ms3)):
        _check_range(name, m, 0, NUM_MATRIX_REGS - 1)
    word = InstrWord(func5=n, width=width).encode()
    return Offload(word=word, operands=Operands.for_xmk(
        md=md, ms1=ms1, ms2=ms2, ms3=ms3, alpha=alpha, beta=beta))


def fx_encode(x: float) -> int:
    """Encode a float scalar into the 16-bit Q8.8 operand half."""
    v = int(round(x * (1 << Q)))
    if not -0x8000 <= v <= 0x7FFF:
        raise ValueError(f"scalar {x} out of Q8.8 range")
    return v & 0xFFFF


def fx_decode(v: int) -> float:
    """Interpret a 16-bit operand half as signed Q8.8."""
    v &= 0xFFFF
    if v >= 0x8000:
        v -= 0x10000
    return v / (1 << Q)
