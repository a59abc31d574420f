"""Host-side federated pieces the serving slice needs: the projection side
rule, shape buckets, the target split and the client-state store."""
