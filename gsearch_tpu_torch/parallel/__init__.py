from .mesh import (DeviceMesh, MeshGraphSearcher, MeshMxuSearcher, MeshSearcher, initialize_multihost,
                   make_device_mesh, shard_database, sharded_knn, sharded_sketch_and_knn_step)
