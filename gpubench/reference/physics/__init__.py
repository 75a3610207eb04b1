"""A frozen copy of ``mjrl_tpu_torch/physics``'s plain version (``model``,
``tables``, ``math3d``, ``soa``, ``soa_newton``, and of ``engine`` and
``csolve`` the kinematics and the solver's parameters that they read), its
imports pointed here, so that a change to the port's
physics moves neither the reference nor the benchmark's operation counts."""
