"""System registry: name -> constructor, so configs can select dynamics
declaratively (the intent behind the reference's empty systems/car.yaml)."""

from __future__ import annotations

from typing import Callable

from cudasbmp_jax.systems.base import System
from cudasbmp_jax.systems.bicycle import KinematicBicycle
from cudasbmp_jax.systems.double_integrator import DoubleIntegrator2D
from cudasbmp_jax.systems.dubins import DubinsCar
from cudasbmp_jax.systems.point2d import Point2D
from cudasbmp_jax.systems.unicycle import Unicycle

_REGISTRY: dict[str, Callable[..., System]] = {}


def register_system(name: str, ctor: Callable[..., System]) -> None:
    _REGISTRY[name] = ctor


def get_system(name: str, **kwargs) -> System:
    if name not in _REGISTRY:
        raise KeyError(f"unknown system {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_systems() -> list[str]:
    return sorted(_REGISTRY)


register_system("bicycle", KinematicBicycle)
register_system("car", KinematicBicycle)  # alias matching systems/car.yaml intent
register_system("point2d", Point2D)
register_system("double_integrator", DoubleIntegrator2D)
register_system("unicycle", Unicycle)
register_system("dubins", DubinsCar)
