"""Typed configuration with CLI overrides (the port's copy of
musicfpaugment_tpu/utils/config.py): dataclass configs whose fields can be
overridden as ``--key=value`` flags, beside the plain parameter dicts that
``AugmentFP`` takes."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Sequence, Type, TypeVar

T = TypeVar("T")


def add_dataclass_args(parser: argparse.ArgumentParser, cls: Type[Any]) -> None:
    for field in dataclasses.fields(cls):
        arg = "--" + field.name.replace("_", "-")
        default = (
            field.default
            if field.default is not dataclasses.MISSING
            else (
                field.default_factory()  # type: ignore[misc]
                if field.default_factory is not dataclasses.MISSING
                else None
            )
        )
        if field.type in (bool, "bool"):
            parser.add_argument(
                arg, type=lambda v: str(v).lower() in ("1", "true", "yes"),
                default=default,
            )
        else:
            typ = {"int": int, "float": float, "str": str}.get(
                str(field.type), field.type if callable(field.type) else str
            )
            parser.add_argument(arg, type=typ, default=default)


def parse_into(cls: Type[T], argv: Sequence[str] | None = None) -> T:
    """Parse CLI args into a dataclass instance."""
    parser = argparse.ArgumentParser()
    add_dataclass_args(parser, cls)
    ns, _ = parser.parse_known_args(argv)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(ns).items() if k in names})


def asdict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


@dataclasses.dataclass
class TrainConfig:
    """Training defaults mirroring training/parameters.py."""

    model: str = "unet"
    batch_size: int = 128
    train_steps: int = 64
    val_steps: int = 64
    learning_rate: float = 1e-3
    nb_epochs: int = 500
    patience: int = 10
    factor: float = 0.1
    early_stop: int = 20
    min_delta: float = 0.0
    factor_sc: float = 0.5
    factor_mag: float = 0.5
    duration: int = 3
    sample_rate: int = 8000
    seed: int = 59
