"""Model assembly of the port (torch counterpart of `repro.models`)."""
