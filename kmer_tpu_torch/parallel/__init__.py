from .mesh import make_mesh, mesh_shape_for  # noqa: F401
from .dist import make_sharded_count_step, count_kmers_sharded  # noqa: F401
from .shindex import ShardedIndex  # noqa: F401
