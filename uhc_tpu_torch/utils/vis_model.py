"""Multi-actor visualization MJCF builder (the port's own copy of
uhc_tpu.utils.vis_model: host code, stdlib xml.etree only).

`create_vis_model` duplicates the humanoid subtree `num` times (prefixing
body / joint / site names with the copy index), strips <actuator>,
<contact> and <equality>, and disables contacts, so a viewer can overlay
several kinematic actors (e.g. reference vs policy) in one scene.

Usage:
  python -m uhc_tpu_torch.utils.vis_model --in-model H.xml --out-model V.xml
      [--num 10]
"""
from __future__ import annotations

import copy
import xml.etree.ElementTree as ET


def create_vis_model(in_file: str, out_file: str, num: int = 10) -> None:
    """Write a visualization copy of `in_file` with `num` humanoid clones.

    Copy i's body/joint/site names are prefixed "i_" (copy 0 keeps the
    original names), matching vis_model_utils.py:26-32.
    """
    tree = ET.parse(in_file)
    root = tree.getroot()

    for elem in ("actuator", "contact", "equality"):
        node = root.find(elem)
        if node is not None:
            root.remove(node)

    option = root.find("option")
    if option is None:
        option = ET.SubElement(root, "option")
    ET.SubElement(option, "flag", {"contact": "disable"})
    size = ET.Element("size", {"njmax": "1000"})
    # insert <size> right after <option> (lxml option.addnext equivalent)
    children = list(root)
    root.insert(children.index(option) + 1, size)

    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError(f"{in_file}: no <worldbody>")
    body = worldbody.find("body")
    if body is None:
        raise ValueError(f"{in_file}: no root <body> under <worldbody>")
    for i in range(1, num):
        new_body = copy.deepcopy(body)
        for node in [new_body] + new_body.findall(".//body"):
            node.set("name", f"{i}_{node.get('name')}")
        for tag in ("joint", "freejoint", "site"):
            for node in new_body.findall(f".//{tag}"):
                if node.get("name"):
                    node.set("name", f"{i}_{node.get('name')}")
        worldbody.append(new_body)

    try:
        ET.indent(tree)          # pretty_print equivalent (py3.9+)
    except AttributeError:
        pass
    tree.write(out_file)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m uhc_tpu_torch.utils.vis_model")
    p.add_argument("--in-model", required=True)
    p.add_argument("--out-model", required=True)
    p.add_argument("--num", type=int, default=10)
    args = p.parse_args(argv)
    create_vis_model(args.in_model, args.out_model, args.num)
    print(f"wrote {args.out_model}")


if __name__ == "__main__":
    main()
