"""Host-side helpers of the port (the pytree slice of ``jax.tree_util``)."""
