"""The recipes' configs: ``yaml_lite`` reads their YAML, ``config`` merges it
over the defaults and makes the port config."""
