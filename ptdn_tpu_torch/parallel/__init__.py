"""Multi-device rendering: the image's rows split into shards
(ptdn_tpu/parallel/ of the JAX package). mesh.py holds the shard groups
and the exchanges a shard's frame asks of its group, halo.py the row
halos, sharded.py the sharded frame step, dryrun.py a one-step check."""
