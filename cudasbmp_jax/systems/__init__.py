from cudasbmp_jax.systems.base import System, ControlSpec
from cudasbmp_jax.systems.bicycle import KinematicBicycle
from cudasbmp_jax.systems.point2d import Point2D
from cudasbmp_jax.systems.double_integrator import DoubleIntegrator2D
from cudasbmp_jax.systems.unicycle import Unicycle
from cudasbmp_jax.systems.dubins import DubinsCar
from cudasbmp_jax.systems.registry import get_system, register_system, available_systems

__all__ = [
    "System",
    "ControlSpec",
    "KinematicBicycle",
    "Point2D",
    "DoubleIntegrator2D",
    "Unicycle",
    "DubinsCar",
    "get_system",
    "register_system",
    "available_systems",
]
