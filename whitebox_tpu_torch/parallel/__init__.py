"""Multi-device rendering over ``torch.distributed``: the render mesh, the
sharded mix, frame-sharded effect chains.

Counterpart of ``whitebox_tpu/parallel``. Every rank runs the same entry
point on the same session (SPMD) over a ('tracks', 'frames') mesh of
ranks (``mesh.make_render_mesh``):

- ``tracks``: the reduction axis. Each rank renders a track shard; the mix
  is an ordered sum over the axis (``collectives.ordered_sum``: partials
  gathered and added in rank order, deterministic on every backend);
- ``frames``: the data-parallel axis. Frame shards never exchange audio;
  effect state crosses them as O(summary) transitions
  (``biquad_sharded``, ``effects_sharded``) folded into each shard's exact
  incoming state.

``launch.run_world`` starts a world of ranks on one host (the tests'
gloo worlds on the CPU; ranks sharing one card); under ``torchrun`` the
entry points find the process group the launcher initialised.
"""

from whitebox_tpu_torch.parallel.mesh import make_render_mesh  # noqa: F401
from whitebox_tpu_torch.parallel.render_sharded import bounce_sharded  # noqa: F401
