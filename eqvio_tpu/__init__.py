"""Equivariant visual-inertial odometry (EqVIO capabilities) in JAX.

A from-scratch re-design of the reference EqVIO pipeline (pvangoor/eqvio) for
accelerators: fixed-capacity masked landmark state, jitted pure-function filter
steps, batched Lie-group math, a batched feature tracker and sharded
multi-sequence execution over a device mesh.
"""

__version__ = "0.1.0"
