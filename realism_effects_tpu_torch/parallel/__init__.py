"""Row sharding of the frame over a mesh of devices: the port of the JAX
package's ``parallel/`` (``sharding``, ``context``, ``halo``)."""
