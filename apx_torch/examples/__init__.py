"""The port's twins of apx's ``examples/``: the training recipes and the two
small examples, one module per script and of the same name.

* ``train_ppo_lidar``: PPO on ``LIDARLocRooms-v0`` with the prediction
  head trained through the env's differentiable loss;
* ``train_ppo_mesh``: the same iteration on a (data, model) grid of
  ``torch.distributed`` ranks (env batch data-parallel, encoder and trunk
  tensor-parallel);
* ``train_vtrace_mesh``: the off-policy IMPALA learner (V-trace) on that
  grid;
* ``train_r2d2_mesh``: the recurrent replay learner (R2D2) on that grid;
* ``rollout_functional``: a random-policy rollout of any id;
* ``gym_compat``: the gymnasium drop-in driven as the reference's scripts
  drive it.

Each runs as ``python -m apx_torch.examples.<name>`` on the card; the
functions take ``device="cpu"`` for the plain PyTorch forms.
"""
