"""Data parallelism: devices, process groups, rank launcher, batch split
(``mesh``) and the data-parallel dry run (``dryrun``)."""
