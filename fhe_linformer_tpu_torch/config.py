"""Config presets: a copy of the JAX package's `PRESETS` (same names and
scheme parameters)."""

from __future__ import annotations

from dataclasses import dataclass, field

from .ckks.context import CKKSConfig
from .models.circuit import CircuitParams


@dataclass(frozen=True)
class Preset:
    name: str
    desc: str
    ckks: CKKSConfig
    circuit: CircuitParams = field(default_factory=CircuitParams)
    d: int = 128
    k_lin: int = 32
    d_ffn: int = 512
    n_classes: int = 20
    max_seq: int = 700
    layers: int = 1
    bootstrap: bool = False


PRESETS: dict[str, Preset] = {}


def _reg(p: Preset) -> Preset:
    PRESETS[p.name] = p
    return p


_reg(Preset(
    name="roundtrip",
    desc="encrypt -> ct-pt linear projection -> decrypt (IMDB fasttext d128)",
    ckks=CKKSConfig(n=1 << 15, scale_bits=26, num_scaling=4, dnum=2),
))
_reg(Preset(
    name="bsgs-projection",
    desc="Galois rotations + BSGS ct matmul for E/F low-rank projection",
    ckks=CKKSConfig(n=1 << 15, scale_bits=26, num_scaling=8, dnum=2),
))
_reg(Preset(
    name="attention-noboot",
    desc="encrypted attention + poly softmax + value matmul, no bootstrap",
    ckks=CKKSConfig(n=1 << 15, scale_bits=26, num_scaling=30, dnum=5),
))
_reg(Preset(
    name="linformer-boot",
    desc="full single-layer encrypted Linformer with bootstrapping (R8)",
    ckks=CKKSConfig(n=1 << 15, scale_bits=26, num_scaling=44, dnum=3,
                    secret_hw=32),
    bootstrap=True,
))
_reg(Preset(
    name="linformer-boot-w",
    desc="single-layer encrypted Linformer, wide (paired-scale) bootstrap",
    ckks=CKKSConfig(n=1 << 15, scale_bits=26, num_scaling=58, dnum=3,
                    secret_hw=32),
    bootstrap=True,
))
_reg(Preset(
    name="multi-layer",
    desc="multi-layer encrypted Linformer classification end-to-end",
    ckks=CKKSConfig(n=1 << 15, scale_bits=26, num_scaling=58, dnum=3,
                    secret_hw=32),
    layers=2,
    bootstrap=True,
))
_reg(Preset(
    name="linformer-128c",
    desc="full bootstrapped Linformer at >=128-bit classical security",
    ckks=CKKSConfig(n=1 << 16, scale_bits=26, num_scaling=46, dnum=3),
    bootstrap=True,
))
_reg(Preset(
    name="tiny",
    desc="test-scale model: d=8, k=4, slots=128",
    ckks=CKKSConfig(n=256, scale_bits=26, num_scaling=58, dnum=8),
    circuit=CircuitParams(inv_range=(0.5, 40.0), inv_degree=13,
                          gelu_clip=1.0 / 4, gelu_degree=13,
                          tanh_scale=1.0 / 4, tanh_degree=13),
    d=8, k_lin=4, d_ffn=32, n_classes=5, max_seq=12,
))


def get(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
