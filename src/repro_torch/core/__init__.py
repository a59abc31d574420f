"""The federated core: projectors, GaLoreAdamW, factored aggregation and
state sync, AJIVE, the FedGaLore engine, and the client-state store."""
