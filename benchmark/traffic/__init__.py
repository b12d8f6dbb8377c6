"""Traffic: the frozen stream generator, one module a traffic kind, one
JSON file a traffic mix."""
