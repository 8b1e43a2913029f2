"""Scale-out of the map over several processes (port of mrhash_tpu/parallel):
`sharding` holds the key-owner sharded frame steps, `launch` starts one
process per rank and gives each its process group."""
