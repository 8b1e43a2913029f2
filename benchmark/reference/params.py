"""Compile-time constants of the port.

A copy of mrhash_tpu/params.py (the reference's tunables,
mrhash/src/sdf/params.h:4-63): the port imports nothing of the JAX
package.  Hash / block / weight semantics are bit-compatible with the
reference, so maps convert between the two packages 1:1.
"""

# --- hash-entry status flags (params.h:4-6) ---------------------------------
FREE_ENTRY = -2  # slot holds no block
LOCK_ENTRY = -1  # reference-only bucket lock value; kept for serialization parity

# --- spatial-hash primes (params.h:7-9) --------------------------------------
P0 = 73856093
P1 = 19349669
P2 = 83492791

# --- block geometry (params.h:10-13) -----------------------------------------
SDF_BLOCK_SIZE = 8                                  # voxels per side, resolution 0
TOTAL_SDF_BLOCK_SIZE = SDF_BLOCK_SIZE ** 3          # 512 voxels / block
FINEST_BLOCK_LOG2_DIM = 3
OCTREE_BRANCHING_FACTOR = 8                         # res-0 block splits into 8 res-1 blocks
LOW_BLOCK_SIZE = SDF_BLOCK_SIZE // 2                # 4 voxels per side, resolution 1
TOTAL_LOW_BLOCK_SIZE = LOW_BLOCK_SIZE ** 3          # 64 voxels / low block

# --- hash table shape (params.h:14,19) ---------------------------------------
HASH_BUCKET_SIZE = 10      # primary slots per bucket
LINKED_LIST_SIZE = 7       # reference's overflow-list length; here: extra linear probes
# total probes per key: bucket slots + overflow probes.  The reference resolves
# bucket overflow with a cross-bucket linked list of <=7 entries
# (voxel_data_structures.cu:79-127); we use the same worst-case occupancy as
# additional deterministic linear probes, which a full-scan vectorized lookup
# makes deletion-safe without tombstones.
NUM_PROBES = HASH_BUCKET_SIZE + LINKED_LIST_SIZE    # 17

# --- integration (params.h:24-31) ---------------------------------------------
INTEGRATION_WEIGHT_MAX = 255
MAX_DDA_ITERATION_COUNT = 1024   # reference bound; our static DDA step count is derived per-config
N_ITERATION_BISECTION = 3
CAMERA_UPSCALING_STARVING_FACTOR = 2.0
STREAM_THRESHOLD = 0.15          # stream out when high-heap free count <= 15% of capacity
STREAM_TARGET = 0.35             # budgeted eviction recovers free heap to
#                                  this watermark per trigger (farthest-
#                                  first; keeps trigger frequency ~20x
#                                  lower than the reference's fixed-radius
#                                  shell policy — plan_evictions docstring)
DEFAULT_SDF_VAR_THRESHOLD = 0.0
DEFAULT_VERTICES_MERGING_THRESHOLD = 0.0
DEFAULT_PROJECTIVE_SDF = True
DEFAULT_GS_OPTIMIZATION_PARAM_PATH = ""

# --- memory budgeting ratios (params.h:33-37) ---------------------------------
SDF_BLOCKS_RATIO = 0.70
MESH_RATIO = 0.25
RADIUS_SCALE_CHUNK = 10.0
SDF_BLOCKS_STREAM_RATIO = 0.10
GS_SCALING_RATIO = 0.20

FLOAT_EPSILON = 1e-6
COORD_EPSILON = 1e-5   # sign-aware floor/ceil epsilon (voxel_hash_utils.cuh:80,145)

# --- quad-tree (params.h:20-23) ------------------------------------------------
MAX_NUM_QTREE_NODES = 1_000_000
QTREE_LEAVES_CAPACITY = MAX_NUM_QTREE_NODES

# --- byte sizes used by the memory budget (matching the reference structs) ----
VOXEL_NBYTES = 16       # sdf f32 + sum_squared f32 + rgb u8x3 + weight u8 (+pad)
TRIANGLE_NBYTES = 72    # 3 vertices x (pos f32x3 + color f32x3)
