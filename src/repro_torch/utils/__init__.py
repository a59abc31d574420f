"""Host-side helpers of the port: the pytree slice of ``jax.tree_util``
(``tree``) and the threefry slice of ``jax.random`` (``prng``)."""
