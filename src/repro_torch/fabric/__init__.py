"""FlowMesh fabric on the port: for now only ``spec``, the declarative
workflow documents and named templates that ``core.workloads`` compiles
through. Admission, replay, the service and its API come later."""
from .spec import (TEMPLATES, SpecError, compile_spec, default_resource_class,
                   list_templates, render_template, validate_spec)

__all__ = ["TEMPLATES", "SpecError", "compile_spec", "default_resource_class",
           "list_templates", "render_template", "validate_spec"]
