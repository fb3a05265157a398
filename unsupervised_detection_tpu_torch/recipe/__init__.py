"""The recipe that made the flagship detector, counterpart of the JAX
repo's experiment tools: the synthetic scenes (`scenes`,
tools/exp_convergence_v2.make_batch_fn and tools/exp_scenes.py), the
region-EPE diagnostic (`flow_diag`, tools/exp_flow_diag.py), the
two-player game (`game`, tools/exp_convergence_v2.py) and the PWC
pretraining recipe (`pretrain_pwc`, tools/exp_pretrain_pwc.py); and the
instruments that read the game: the game on given flow with no PWC
(`synth`, tools/exp_convergence_synth.py), the game-log summary
(`game_stats`, tools/exp_game_stats.py) and the mask inspector
(`inspect_mask`, tools/exp_inspect_game_mask.py)."""
