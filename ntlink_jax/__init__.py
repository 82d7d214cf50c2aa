"""ntlink-jax: a long-read scaffolding engine on the GPU.

From-scratch reimplementation of the capabilities of bcgsc/ntLink with a
JAX/XLA compute path (see DESIGN.md). Public entry points:

- ``ntlink_jax.pipeline``: stage drivers (`scaffold`, `pair`, `gap_fill`, rounds)
- ``ntlink_jax.cli``: the `ntlink` command line (reference-compatible flags)
- ``ntlink_jax.sketch``: minimizer sketching (indexlr-equivalent)
"""

__version__ = "0.1.0"
