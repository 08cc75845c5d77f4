"""Parameter, batch and activation sharding of the LM over a DeviceMesh
(port of ``repro/sharding``): ``rules`` holds the JAX package's rules as
data, ``placement`` maps them onto DTensor placements and holds the
local-shard helpers the binary linear, the cache writes and the optimizer
use."""
