"""Run-time control of the port (``bluefog_tpu/run/``): the churn
supervisor (``run/supervisor.py``), the ``bfrun`` launcher (``run/run.py``,
``python -m bluefog_tpu_torch.run``) and the interactive cluster:
``ibfrun`` (``run/interactive.py``, ``python -m
bluefog_tpu_torch.run.interactive``) with its HMAC-authenticated
cell channel, line REPL and Jupyter kernel (``run/cluster_repl.py``)."""
