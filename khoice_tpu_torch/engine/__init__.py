"""Device engine of the port: packing, the shared-sort k-sweep, budgets."""
