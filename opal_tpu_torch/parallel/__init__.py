"""Domain-decomposition pieces of the step: the ring of ranks
(``dist``), the halo exchange and current fold, the maintenance sort
and the migration between ranks."""
