"""Fused propagate+check kernel for the GPU, in Pallas on the Triton route.

The analog of the reference's ``propagateG`` + ``propagateAndCheck``
(KGMT.cu:341-411, statePropagator.cu:5-76): one rollout per lane, its state
and the whole ``num_disc``-step Euler loop held in registers, every step's
swept AABB tested against every obstacle with an early "alive" mask, and the
obstacle set read once per program as scalars. XLA lowers the plain
``ops.rollout.rollout_batch`` (``lax.scan`` over the steps, ``[B, K]``
broadcast tests) as a device loop of several kernels per step; here the
whole rollout is one launch.

Layout: each program owns ``BLOCK`` consecutive lanes of the caller's
``[B, state_dim]`` / ``[B, control_dim]`` arrays and reads them with masked
strided loads (the reference's array-of-structs layout), so the wrapper adds
no transpose, pad or slice around the call.

The kernel is generic over dynamics: a system joins by providing the
structure-of-arrays hooks ``soa_prepare`` and ``soa_step`` (per-component
arrays instead of a stacked state; see systems.base.SoAStepMixin).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from cudasbmp_jax.utils.vma import pvary_like, vma_of

# Lanes per program and warps per program: one lane per thread. BLOCK must
# be a power of two (Triton's block shapes).
BLOCK = 128
NUM_WARPS = 4


def supports_system(system) -> bool:
    """A system joins the fused path by providing the SoA step hooks."""
    return hasattr(system, "soa_prepare") and hasattr(system, "soa_step")


def _footprint_clear(obs_ref, nx, ny, ct, st, footprint):
    """Oriented-footprint narrow phase at one pose against every obstacle,
    as a loop over the obstacle rows: unrolled over K and num_disc it
    makes a kernel Triton takes minutes to compile."""
    hl, hw = footprint
    fcx = nx + hl * ct
    fcy = ny + hl * st
    act, ast = jnp.abs(ct), jnp.abs(st)

    def body(k, clear):
        oxmin, oymin = obs_ref[k, 0], obs_ref[k, 1]
        oxmax, oymax = obs_ref[k, 2], obs_ref[k, 3]
        bcx = (oxmin + oxmax) * 0.5
        bcy = (oymin + oymax) * 0.5
        bhx = (oxmax - oxmin) * 0.5
        bhy = (oymax - oymin) * 0.5
        valid_box = (bhx >= 0) & (bhy >= 0)  # keep 0-thickness walls
        dx = fcx - bcx
        dy = fcy - bcy
        sep_x = jnp.abs(dx) >= bhx + hl * act + hw * ast
        sep_y = jnp.abs(dy) >= bhy + hl * ast + hw * act
        sep_u = jnp.abs(dx * ct + dy * st) >= hl + bhx * act + bhy * ast
        sep_v = jnp.abs(dy * ct - dx * st) >= hw + bhx * ast + bhy * act
        return clear & ~(valid_box & ~(sep_x | sep_y | sep_u | sep_v))

    return jax.lax.fori_loop(0, obs_ref.shape[0], body,
                             jnp.ones_like(nx, dtype=jnp.bool_))


def _integrate(system, comps, ctrl, dur, obs_ref, num_disc: int,
               width: float, height: float,
               footprint: tuple[float, float] | None = None,
               fast_math: bool = False):
    """Kernel body: unrolled Euler loop + per-step swept-AABB tests (+ the
    optional oriented-footprint narrow phase, geometry/footprint.py).

    Break-semantics parity with the reference (statePropagator.cu:31-65):
    dead lanes freeze at their failing-step candidate position. dt uses a
    true division (not reciprocal-multiply) and the footprint math mirrors
    footprint_clear's op order, so the body computes the same float
    operations as the jnp path (rollout.py).
    """
    obs = [tuple(obs_ref[k, c] for c in range(4))
           for k in range(obs_ref.shape[0])]
    dt = dur / num_disc
    use_fast = fast_math and hasattr(system, "soa_step_fast")
    if use_fast:
        carry, aux = system.soa_prepare_fast(comps, ctrl, dt)
    else:
        aux = system.soa_prepare(ctrl)
    alive = jnp.ones_like(comps[0], dtype=jnp.bool_)
    heading_index = getattr(system, "heading_index", None)
    for _ in range(num_disc):
        if use_fast:
            new, new_carry = system.soa_step_fast(comps, carry, aux, dt)
        else:
            new = system.soa_step(comps, aux, dt)
        nx, ny, x, y = new[0], new[1], comps[0], comps[1]
        clear = (nx > 0.0) & (nx < width) & (ny > 0.0) & (ny < height)
        bb_min_x = jnp.minimum(x, nx)
        bb_max_x = jnp.maximum(x, nx)
        bb_min_y = jnp.minimum(y, ny)
        bb_max_y = jnp.maximum(y, ny)
        for (oxmin, oymin, oxmax, oymax) in obs:
            # degenerate padding boxes (max < min) are separated from all
            sep = ((bb_max_x <= oxmin) | (oxmax <= bb_min_x)
                   | (bb_max_y <= oymin) | (oymax <= bb_min_y))
            clear = clear & sep
        if footprint is not None:
            if use_fast and heading_index is not None:
                # hook contract: carry[0:2] = cos/sin of the current state,
                # so new_carry[0:2] is the post-step pose's cos/sin
                ct, st = new_carry[0], new_carry[1]
            elif heading_index is not None:
                theta = new[heading_index]
                ct = jnp.cos(theta)
                st = jnp.sin(theta)
            else:
                ct = jnp.ones_like(nx)
                st = jnp.zeros_like(nx)
            clear = clear & _footprint_clear(obs_ref, nx, ny, ct, st,
                                             footprint)
        comps = [jnp.where(alive, n, c) for n, c in zip(new, comps)]
        if use_fast:
            # dead lanes' carry may keep rotating — harmless, their comps
            # are frozen and alive never resurrects
            carry = new_carry
        alive = alive & clear
    return comps, alive


def _rollout_kernel(x0_ref, ctrl_ref, obs_ref, x1_ref, valid_ref, *, system,
                    num_disc: int, width: float, height: float, footprint,
                    fast_math: bool):
    n_lanes, S = x0_ref.shape
    C = ctrl_ref.shape[1]
    start = pl.program_id(0) * BLOCK
    lanes = pl.ds(start, BLOCK)
    mask = start + jnp.arange(BLOCK, dtype=jnp.int32) < n_lanes
    comps = [plgpu.load(x0_ref.at[lanes, j], mask=mask, other=0.0)
             for j in range(S)]
    ctrl = [plgpu.load(ctrl_ref.at[lanes, j], mask=mask, other=0.0)
            for j in range(C)]
    comps, alive = _integrate(system, comps, ctrl[:-1], ctrl[-1], obs_ref,
                              num_disc, width, height, footprint, fast_math)
    for j, c in enumerate(comps):
        plgpu.store(x1_ref.at[lanes, j], c, mask=mask)
    plgpu.store(valid_ref.at[lanes], alive.astype(jnp.int32), mask=mask)


@functools.partial(
    jax.jit,
    static_argnames=("system", "num_disc", "width", "height", "interpret",
                     "footprint", "fast_math"),
)
def rollout_pallas(
    system,
    x0: jax.Array,  # [B, state_dim] start states
    controls: jax.Array,  # [B, control_dim] (duration last)
    obstacles: jax.Array,  # [K, 4]
    *,
    num_disc: int,
    width: float,
    height: float,
    interpret: bool = False,
    footprint: tuple[float, float] | None = None,
    fast_math: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Fused rollout for any SoA-capable system. Same contract as
    ops.rollout.rollout_batch (including the optional oriented-footprint
    narrow phase): returns (x1 [B, state_dim], valid [B]).

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on
    a machine without a GPU)."""
    B, S = x0.shape
    if obstacles.shape[0] == 0:
        # one degenerate box (max < min) keeps the kernel's operand non-empty
        obstacles = jnp.array([[1.0, 1.0, 0.0, 0.0]], jnp.float32)
    # under shard_map (sharded tree, streaming run_sharded) the operands and
    # outputs must share one varying-axes type; outside it this is a no-op
    operands = pvary_like((x0.astype(jnp.float32),
                           controls.astype(jnp.float32),
                           obstacles.astype(jnp.float32)),
                          x0, controls, obstacles)
    vma = vma_of(operands[0])
    kernel = functools.partial(
        _rollout_kernel, system=system, num_disc=num_disc, width=width,
        height=height, footprint=footprint, fast_math=fast_math)
    x1, valid = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(B, BLOCK),),
        out_shape=(jax.ShapeDtypeStruct((B, S), jnp.float32, vma=vma),
                   jax.ShapeDtypeStruct((B,), jnp.int32, vma=vma)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="rollout_pallas",
    )(*operands)
    return x1, valid != 0
