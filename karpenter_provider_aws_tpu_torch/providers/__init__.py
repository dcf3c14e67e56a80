"""Cloud resource adapters (reference L4: ``pkg/providers/*``).

Each provider wraps the cloud backend with TTL caching and the selection
logic its reference counterpart implements: subnet zonal pick + in-flight IP
accounting, security-group discovery, image resolution (AMI-family
analogue), instance-profile lifecycle, launch-template ensure/dedupe with
per-family bootstrap userdata, and cluster-version discovery.
"""

from .subnets import SubnetProvider  # noqa: F401
from .securitygroups import SecurityGroupProvider  # noqa: F401
from .images import ImageProvider, resolve_image_for  # noqa: F401
from .instanceprofiles import InstanceProfileProvider  # noqa: F401
from .bootstrap import ClusterInfo, KubeletConfiguration, bootstrapper_for, mime_merge  # noqa: F401
from .launchtemplates import LaunchTemplateProvider, ResolvedTemplate  # noqa: F401
from .version import VersionProvider  # noqa: F401
