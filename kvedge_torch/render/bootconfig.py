"""The boot-config document — the cloud-init user-data analogue.

The port's copy of ``kvedge_tpu/render/bootconfig.py``. ``CONFIG_SERIAL``,
the mounts, ``RUNTIME_HOSTNAME`` and every command line are byte-equal
to the JAX package's, so either package's bootstrap reads either
package's document; only the three comment lines about the image differ.

Reference: ``aziotedgevm.cloudinit`` (``_helper.tpl:31-75``) renders a
``#cloud-config`` document that (a) sets the hostname, (b) authorizes the
operator's SSH key, (c) ``bootcmd``-mounts the config-secret disk found *by
serial* at ``/mnt/app-secret`` (:61-64), and (d) ``runcmd``-installs the
runtime and applies the injected config (:68-74). The document travels as a
Secret so boot behavior is data, changeable without rebuilding the boot
image.

Here it is a ``#kvedge-boot-config`` YAML document, shipped as a Secret,
parsed and executed by :mod:`kvedge_torch.bootstrap.entrypoint` inside the
runtime container. The apt-install steps have no analogue: the GPU image
(``deployment/gpu/Dockerfile``) ships PyTorch for CUDA and the port's
kernels already built, so ``runcmd`` goes straight to config-apply +
runtime boot. ``kvedge-runtime boot`` names no device: a rendered pod
runs on its GPU.

Identity-based config discovery: the reference tags the config disk with a
serial and the guest greps ``lsblk`` for it. Pods have no disk serials, so
the config Secret is mounted under a serial-named directory
(``/mnt/disks/<serial>``) and the bootstrap scans the search root for that
serial.
"""

from __future__ import annotations

from kvedge_torch.config.values import ChartValues
from kvedge_torch.utils.gojson import go_json

# The config-volume serial tag (analogue of D23YZ9W6WA5DJ487,
# aziot-edge-vm.yaml:28): the JAX package's, so the documents cross.
CONFIG_SERIAL = "KV9TPU3EDGE7R412"

# Where the pod spec mounts serial-tagged volumes; bootstrap scans this root.
DISKS_ROOT = "/mnt/disks"

# Stable link the bootstrap creates once the serial is located
# (analogue of the `/mnt/app-secret` mount point, _helper.tpl:62-64).
APP_SECRET_MOUNT = "/mnt/app-secret"

# Where the boot-config Secret is mounted (analogue of the NoCloud cdrom).
BOOT_SECRET_MOUNT = "/mnt/boot-secret"

# Fixed in-pod hostname (analogue of `hostname: iotedgevm`, _helper.tpl:33).
RUNTIME_HOSTNAME = "kvedgetpuvm"

HEADER = "#kvedge-boot-config"


def boot_config_document(values: ChartValues) -> str:
    """Render the boot-config YAML (the ``aziotedgevm.cloudinit`` analogue).

    Emitted as literal text (not via a YAML dumper) so the document is
    byte-stable for golden tests and for the Helm-chart consistency check.
    The SSH key is JSON-quoted with Go's escaping rules (valid YAML
    double-quoted scalar, byte-matching Helm's ``toJson``): an empty key
    stays a string instead of parsing as YAML ``null``, and keys containing
    ``: `` or ``#`` can't corrupt the document.
    """
    ssh_key = go_json(values.publicSshKey)
    return (
        f"{HEADER}\n"
        f"hostname: {RUNTIME_HOSTNAME}\n"
        "ssh_authorized_keys:\n"
        f"  - {ssh_key}\n"
        "bootcmd:\n"
        "# locate the config Secret volume by serial and link it\n"
        f'  - "kvedge-bootstrap locate --serial {CONFIG_SERIAL}'
        f' --search-root {DISKS_ROOT} --link {APP_SECRET_MOUNT}"\n'
        "# Once the pod is started the following commands apply the injected\n"
        "# runtime config and boot the PyTorch runtime on the GPU. The image\n"
        "# ships PyTorch for CUDA and the built kernels: no install step.\n"
        "runcmd:\n"
        f'  - "kvedge-bootstrap apply --source {APP_SECRET_MOUNT}/userdata'
        ' --target /etc/kvedge/config.toml"\n'
        '  - "kvedge-runtime boot --config /etc/kvedge/config.toml"\n'
    )
