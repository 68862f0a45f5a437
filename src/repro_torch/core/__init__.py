"""Framework-neutral helpers copied from ``repro.core``."""
