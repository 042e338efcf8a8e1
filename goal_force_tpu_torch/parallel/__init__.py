"""Placement of the pipeline's models: host staging of the standby expert
(``host_staging``), and multi-GPU serving over a (dp, sp, tp) mesh (``mesh``,
``collectives``, ``sharding``)."""
