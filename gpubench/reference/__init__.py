"""The plain reference that decides a run's ``correct``: plain PyTorch on
float32, importing nothing of ``mjrl_tpu_torch`` (``physics/`` is a frozen
copy of the port's plain physics, ``envs/`` the tasks' observations and
rewards, ``learn.py`` returns, GAE, NPG and the MLP baseline's fit)."""
