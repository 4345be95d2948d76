"""Domain-decomposition pieces of the step at one device: the periodic
halo wrap/fold, the maintenance sort and the edge migration."""
