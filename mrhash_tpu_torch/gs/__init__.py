"""Online 3D Gaussian Splatting on the port (mrhash_tpu/gs): quad-tree
seeding, the tile rasterizer with the K4/K5 blend kernels, the parameter
store with Adam, and the container that GeoWrapper drives."""
