"""Scene ingestion: glTF loading, procedural scenes, and the flat device
tensors the integrator and kernel read."""
