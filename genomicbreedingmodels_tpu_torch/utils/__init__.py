from . import checkpoint, config, devcache, diagnostics
