"""Distribution over ``torch.distributed`` process groups (counterpart of
``cp_pfdr_graph_d1_tpu.parallel``): one rank per shard, the per-shard body
of the JAX package's ``shard_map`` run in every rank (:mod:`.mesh`)."""
from .cp_dist import (cp_loss_d1_simplex_dist, cp_quadratic_d1_dist,
                      shard_cp_quadratic_problem)
from .cp_sharded import cp_quadratic_d1_sharded
from .cp_sharded_simplex import cp_loss_d1_simplex_sharded
from .dp import (DistDenseOp, ShardedQuadraticProblem,
                 ShardedSimplexProblem, pfdr_loss_d1_simplex_sharded,
                 pfdr_quadratic_d1_sharded, shard_quadratic_problem,
                 shard_simplex_problem)
from .halo import (ColShardDenseOp, HaloShardedProblem, HaloSimplexProblem,
                   HaloStencilGraphD1, pfdr_loss_d1_simplex_halo,
                   pfdr_quadratic_d1_halo, shard_stencil_problem,
                   shard_stencil_simplex_problem)
from .mesh import (Mesh, initialize_distributed, make_hybrid_mesh,
                   make_mesh, put_sharded, spawn_ranks)

__all__ = ["cp_loss_d1_simplex_dist", "cp_loss_d1_simplex_sharded",
           "cp_quadratic_d1_sharded", "cp_quadratic_d1_dist",
           "shard_cp_quadratic_problem",
           "DistDenseOp", "ShardedQuadraticProblem",
           "ShardedSimplexProblem", "make_mesh", "make_hybrid_mesh",
           "initialize_distributed", "put_sharded", "Mesh", "spawn_ranks",
           "pfdr_loss_d1_simplex_sharded", "pfdr_quadratic_d1_sharded",
           "shard_quadratic_problem", "shard_simplex_problem",
           "ColShardDenseOp", "HaloShardedProblem", "HaloSimplexProblem",
           "HaloStencilGraphD1",
           "pfdr_loss_d1_simplex_halo", "pfdr_quadratic_d1_halo",
           "shard_stencil_problem", "shard_stencil_simplex_problem"]
