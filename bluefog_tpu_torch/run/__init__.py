"""Run-time control of the port (``bluefog_tpu/run/``): the churn
supervisor (``run/supervisor.py``) and the ``bfrun`` launcher
(``run/run.py``, ``python -m bluefog_tpu_torch.run``).  The interactive
cluster (``ibfrun``) is ROADMAP item 22e."""
