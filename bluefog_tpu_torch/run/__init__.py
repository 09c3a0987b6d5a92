"""Run-time control loops of the port (``bluefog_tpu/run/``): the churn
supervisor (``run/supervisor.py``).  The launchers (``bfrun``) and the
interactive cluster are ROADMAP item 22."""
