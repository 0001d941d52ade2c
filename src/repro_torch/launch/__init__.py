"""Process meshes for the multi-GPU KG path (:mod:`.mesh`)."""
