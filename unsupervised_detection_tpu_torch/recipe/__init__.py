"""The recipe that made the flagship detector, counterpart of the JAX
repo's experiment tools: the synthetic scenes (`scenes`,
tools/exp_convergence_v2.make_batch_fn and tools/exp_scenes.py), the
region-EPE diagnostic (`flow_diag`, tools/exp_flow_diag.py), the
two-player game (`game`, tools/exp_convergence_v2.py) and the PWC
pretraining recipe (`pretrain_pwc`, tools/exp_pretrain_pwc.py)."""
